"""Metrics history ring: a dependency-free on-daemon time series (the port's
copy of mlcomp_tpu/obs/history.py).

``GET /metrics`` answers "what is the value NOW"; every rate, trend,
or burn-rate question needs history, and until this module that meant
running an external Prometheus next to every toy deployment.  The
``MetricsHistory`` sampler closes the gap: a daemon thread snapshots
the serve registry every ``interval_s`` (default 5 s) into a bounded
ring, with the transforms a consumer would otherwise compute:

- **counters** are stored as both lifetime totals and per-interval
  DELTAS, with the Prometheus reset clamp (a counter that stepped
  backwards — an engine restart — contributes its new value as the
  delta, never a negative);
- **gauges** are stored as points;
- **histograms** keep their cumulative bucket counts AND materialize
  per-interval p50/p95/p99 from the bucket-count deltas (linear
  interpolation within a bucket), so "TTFT p95 over the last minute"
  is a read, not an aggregation job.

``GET /metrics/history?window_s=N`` serves the ring as JSON; the SLO
engine (``obs/slo.py``) evaluates burn rates from the same entries via
the ``entries``/``window_quantile``/``window_delta`` accessors.  The
sampler fires registered callbacks after each snapshot — that is how
SLO evaluation stays live without its own thread.

Sample keys match the text exposition (``name{label="v"}``), so a JSON
reader and a scrape dashboard talk about the same series.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

QUANTILES = (0.50, 0.95, 0.99)


def bucket_quantile(bounds: Sequence[float], counts: Sequence[float],
                    q: float,
                    total: Optional[float] = None) -> Optional[float]:
    """Quantile estimate from (finite) bucket bounds + per-bucket
    counts (NOT cumulative), linearly interpolated within the bucket —
    the same estimate ``histogram_quantile`` makes.  ``total`` is the
    full observation count INCLUDING the implicit +Inf bucket's mass
    (observations above the largest finite bound never appear in
    ``counts``); ranks that land in that mass answer with the largest
    finite bound — there is no upper edge to interpolate toward.
    None when there are no observations."""
    finite = float(sum(counts))
    total = finite if total is None else max(float(total), finite)
    if total <= 0:
        return None
    rank = q * total
    cum = 0.0
    lo = 0.0
    for b, c in zip(bounds, counts):
        if cum + c >= rank and c > 0:
            frac = (rank - cum) / c
            return lo + (float(b) - lo) * frac
        cum += c
        lo = float(b)
    return float(bounds[-1]) if bounds else None


class MetricsHistory:
    """Bounded ring of registry snapshots + the sampler thread that
    fills it.  ``max_samples`` defaults to one hour at the default
    5 s interval; ``interval_s`` is the knob behind
    ``--metrics-history-interval``."""

    def __init__(self, registry, interval_s: float = 5.0,
                 max_samples: int = 720,
                 clock: Callable[[], float] = time.time,
                 start: bool = True):
        if interval_s <= 0:
            raise ValueError(
                f"interval_s must be positive, got {interval_s}"
            )
        if max_samples < 2:
            raise ValueError(
                f"max_samples must be >= 2 (deltas need a predecessor),"
                f" got {max_samples}"
            )
        self.registry = registry
        self.interval_s = float(interval_s)
        self.max_samples = int(max_samples)
        self._clock = clock
        self._ring: "deque" = deque(maxlen=self.max_samples)
        self._buckets: Dict[str, List[float]] = {}
        # previous totals for delta computation: counters (floats) and
        # histograms ([counts, sum, n]) by sample key
        self._prev: Dict[str, Any] = {}
        self._callbacks: List[Callable[[], None]] = []
        self._samples_taken = 0
        self._sample_errors = 0
        self._callback_errors = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        registry.register_collector(self._collect_metrics)
        if start:
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="metrics-history",
            )
            self._thread.start()

    # ------------------------------------------------------------ sampling

    def add_callback(self, fn: Callable[[], None]) -> None:
        """``fn()`` runs after every snapshot (on the sampler thread).
        Errors are counted and contained — a broken consumer must not
        stop the history."""
        with self._lock:
            self._callbacks.append(fn)

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.sample_now()
            except Exception:
                with self._lock:
                    self._sample_errors += 1

    @staticmethod
    def _delta(cur: float, prev: Optional[float]) -> float:
        """Prometheus-rate reset semantics: a counter below its last
        reading restarted, so its whole current value is the increase."""
        if prev is None or cur < prev:
            return cur
        return cur - prev

    def sample_now(self) -> Dict[str, Any]:
        """Take one snapshot NOW (the sampler thread calls this every
        interval; tests and tools call it directly for determinism).
        Returns the entry appended to the ring."""
        snap = self.registry.snapshot()
        entry: Dict[str, Any] = {
            "t": self._clock(),
            "counters": {},
            "counter_deltas": {},
            "gauges": {},
            "hist": {},
            "quantiles": {},
        }
        with self._lock:
            for name, fam in snap.items():
                kind = fam["kind"]
                fmt = fam["label_key"]
                for key, val in fam["values"].items():
                    skey = fmt(key)
                    if kind == "counter":
                        cur = float(val)
                        entry["counters"][skey] = cur
                        entry["counter_deltas"][skey] = self._delta(
                            cur, self._prev.get(skey)
                        )
                        self._prev[skey] = cur
                    elif kind == "gauge":
                        entry["gauges"][skey] = float(val)
                    elif kind == "histogram":
                        counts, total, n = val
                        bounds = fam["buckets"] or []
                        self._buckets.setdefault(
                            skey, [float(b) for b in bounds]
                        )
                        prev = self._prev.get(skey)
                        if prev is None or prev[2] > n:
                            # reset clamp, histogram flavor: a restarted
                            # source's whole state is this interval's
                            dc, dn = list(counts), n
                        else:
                            dc = [c - p for c, p in zip(counts, prev[0])]
                            dn = n - prev[2]
                        entry["hist"][skey] = {
                            "counts": list(counts), "sum": float(total),
                            "n": int(n), "delta_counts": dc,
                            "delta_n": int(dn),
                        }
                        qs = {
                            f"p{int(q * 100)}": bucket_quantile(
                                self._buckets[skey], dc, q, total=dn
                            )
                            for q in QUANTILES
                        }
                        entry["quantiles"][skey] = qs
                        self._prev[skey] = [list(counts), total, n]
            self._ring.append(entry)
            self._samples_taken += 1
            callbacks = list(self._callbacks)
        for fn in callbacks:
            try:
                fn()
            except Exception:
                with self._lock:
                    self._callback_errors += 1
        return entry

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        # deregister from the registry (it may outlive this instance —
        # bench's A/B churns samplers against one engine registry): a
        # dead collector would keep republishing frozen values and pin
        # the closed ring in memory
        self.registry.unregister_collector(self._collect_metrics)

    # ------------------------------------------------------------- reading

    def entries(self, window_s: Optional[float] = None
                ) -> List[Dict[str, Any]]:
        """Ring entries (oldest first), optionally only those inside
        the trailing ``window_s``."""
        with self._lock:
            out = list(self._ring)
        if window_s is not None:
            cutoff = self._clock() - float(window_s)
            out = [e for e in out if e["t"] >= cutoff]
        return out

    def window_delta(self, sample_key: str,
                     window_s: Optional[float] = None) -> float:
        """Summed counter increase across the window's intervals
        (reset-clamped per interval)."""
        return float(sum(
            e["counter_deltas"].get(sample_key, 0.0)
            for e in self.entries(window_s)
        ))

    def window_quantile(self, sample_key: str, q: float,
                        window_s: Optional[float] = None
                        ) -> Optional[float]:
        """Quantile of a histogram family's observations that landed
        INSIDE the window — aggregated bucket-count deltas, not the
        lifetime distribution."""
        bounds = self._buckets.get(sample_key)
        if bounds is None:
            return None
        agg: Optional[List[float]] = None
        agg_n = 0
        for e in self.entries(window_s):
            h = e["hist"].get(sample_key)
            if h is None:
                continue
            dc = h["delta_counts"]
            agg = dc if agg is None else [a + d for a, d in zip(agg, dc)]
            agg_n += h["delta_n"]
        if agg is None:
            return None
        return bucket_quantile(bounds, agg, q, total=agg_n)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            held = len(self._ring)
            span = (
                self._ring[-1]["t"] - self._ring[0]["t"] if held > 1
                else 0.0
            )
            return {
                "interval_s": self.interval_s,
                "max_samples": self.max_samples,
                "samples_held": held,
                "samples_taken": self._samples_taken,
                "sample_errors": self._sample_errors,
                "callback_errors": self._callback_errors,
                "span_s": round(span, 3),
            }

    def query(self, window_s: Optional[float] = None) -> Dict[str, Any]:
        """The ``GET /metrics/history`` payload: ring metadata plus the
        window's samples — counter deltas, gauge points, materialized
        interval quantiles — and the latest lifetime counter totals."""
        entries = self.entries(window_s)
        now = self._clock()
        return {
            **self.stats(),
            "window_s": window_s,
            "samples": [
                {
                    "t": e["t"],
                    "age_s": round(max(now - e["t"], 0.0), 3),
                    "counters": e["counter_deltas"],
                    "gauges": e["gauges"],
                    "quantiles": e["quantiles"],
                }
                for e in entries
            ],
            "totals": entries[-1]["counters"] if entries else {},
        }

    def _collect_metrics(self) -> None:
        """The history's own footprint in the registry it samples."""
        st = self.stats()
        self.registry.counter(
            "mlcomp_metrics_history_samples_total",
            "Registry snapshots the history sampler has taken",
        ).set_total(st["samples_taken"])
        self.registry.gauge(
            "mlcomp_metrics_history_span_seconds",
            "Wall-clock span the bounded history ring currently holds",
        ).set(st["span_s"])
