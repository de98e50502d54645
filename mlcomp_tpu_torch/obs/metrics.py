"""Thread-safe Counter/Gauge/Histogram registry with Prometheus text
exposition — stdlib only.

Why not prometheus_client: the serving container bakes in no extra
dependencies, and the subset serving needs (three metric types, fixed
histogram buckets, the 0.0.4 text format) is small enough to own.  The
registry backs ``GET /metrics`` on the serve daemon and the report
server; engine, service, prefix cache, and scheduler workers register
into it.

Two registration styles:

- **hot-path instruments**: ``registry.histogram(...)`` returns a
  handle whose ``observe()`` is a lock + list update — cheap enough
  for per-request paths (the engine observes TTFT/per-token once per
  finished request).
- **scrape-time collectors**: ``registry.register_collector(fn)``
  runs ``fn()`` at render time; the fn snapshots an existing stats
  dict (``engine.stats()``, ``prefix_cache.stats()``) into counters
  and gauges.  Components that already keep monotonic counters don't
  double-count on their hot path — ``Counter.set_total`` pins the
  scraped value to the snapshot, clamped monotonic so a racing
  snapshot can never make a counter go backwards between scrapes.

Exposition follows the text format 0.0.4 rules the ecosystem lints:
one ``# HELP``/``# TYPE`` pair per family, label values escaped
(backslash, quote, newline), histograms as cumulative ``_bucket``
series with ``le`` plus ``_sum``/``_count``.
"""

from __future__ import annotations

import math
import re
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# latency-in-ms buckets wide enough for both a directly-attached chip
# (sub-ms decode steps) and tunnel-attached TTFTs in the seconds
DEFAULT_MS_BUCKETS = (
    1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
    1000.0, 2500.0, 5000.0, 10000.0, 30000.0,
)


def _escape_label_value(v: Any) -> str:
    return (
        str(v)
        .replace("\\", "\\\\")
        .replace("\n", "\\n")
        .replace('"', '\\"')
    )


def _escape_help(v: str) -> str:
    return v.replace("\\", "\\\\").replace("\n", "\\n")


def _fmt_value(v: float) -> str:
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    if float(v).is_integer() and abs(v) < 2**53:
        return str(int(v))
    return repr(float(v))


class _Metric:
    """One metric family: name, help, label schema, per-labelset state."""

    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: Sequence[str] = ()):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in labelnames:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid label name {ln!r}")
        self.name = name
        self.help = str(help)
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        # labelvalues tuple -> state (float, or histogram triple)
        self._values: Dict[Tuple[str, ...], Any] = {}  # guarded_by: _lock

    def _key(self, labels: Dict[str, Any]) -> Tuple[str, ...]:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, "
                f"got {tuple(labels)}"
            )
        return tuple(str(labels[ln]) for ln in self.labelnames)

    def _label_str(self, key: Tuple[str, ...],
                   extra: Tuple[Tuple[str, str], ...] = ()) -> str:
        pairs = [
            f'{ln}="{_escape_label_value(lv)}"'
            for ln, lv in zip(self.labelnames, key)
        ]
        pairs += [f'{ln}="{_escape_label_value(lv)}"' for ln, lv in extra]
        return "{" + ",".join(pairs) + "}" if pairs else ""

    def samples(self) -> List[str]:
        with self._lock:
            return [
                f"{self.name}{self._label_str(k)} {_fmt_value(v)}"
                for k, v in sorted(self._values.items())
            ]

    def data(self) -> Dict[Tuple[str, ...], Any]:
        """Point-in-time copy of the per-labelset state: floats for
        counters/gauges, ``[bucket_counts, sum, count]`` triples for
        histograms — the structured read behind ``Registry.snapshot``
        (the metrics-history sampler), where text exposition would
        force a parse round trip."""
        with self._lock:
            return {
                k: (
                    [list(v[0]), float(v[1]), int(v[2])]
                    if isinstance(v, list) else float(v)
                )
                for k, v in self._values.items()
            }

    def label_key(self, key: Tuple[str, ...]) -> str:
        """``name{a="b",...}`` sample-name formatting for a labelset
        key (matches the text exposition, so history/SLO consumers can
        correlate JSON keys with scraped series)."""
        return f"{self.name}{self._label_str(key)}"


class Counter(_Metric):
    """Monotonically non-decreasing count."""

    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(f"{self.name}: counters cannot decrease")
        k = self._key(labels)
        with self._lock:
            self._values[k] = self._values.get(k, 0.0) + float(amount)

    def set_total(self, value: float, **labels) -> None:
        """Pin the counter to a snapshot total (collector style).  The
        stored value is clamped monotonic: a snapshot read racing the
        source's own update may arrive out of order across scrapes, and
        a counter that steps backwards breaks every rate() query
        downstream."""
        k = self._key(labels)
        with self._lock:
            self._values[k] = max(self._values.get(k, 0.0), float(value))

    def value(self, **labels) -> float:
        with self._lock:
            return float(self._values.get(self._key(labels), 0.0))


class Gauge(_Metric):
    """A value that can go anywhere (depths, bytes, ratios)."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        k = self._key(labels)
        with self._lock:
            self._values[k] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        k = self._key(labels)
        with self._lock:
            self._values[k] = self._values.get(k, 0.0) + float(amount)

    def dec(self, amount: float = 1.0, **labels) -> None:
        self.inc(-amount, **labels)

    def value(self, **labels) -> float:
        with self._lock:
            return float(self._values.get(self._key(labels), 0.0))


class Histogram(_Metric):
    """Fixed-bucket histogram (cumulative ``le`` exposition)."""

    kind = "histogram"

    def __init__(self, name: str, help: str,
                 buckets: Optional[Sequence[float]] = None,
                 labelnames: Sequence[str] = ()):
        super().__init__(name, help, labelnames)
        bs = tuple(sorted(float(b) for b in (buckets or DEFAULT_MS_BUCKETS)))
        if not bs:
            raise ValueError(f"{name}: need at least one bucket bound")
        self.buckets = bs  # +Inf is implicit, added at exposition

    def touch(self, **labels) -> None:
        """Materialize a series at zero so the family renders before
        its first observation — a just-started exporter should expose
        the empty histogram (every bucket 0, count 0, sum 0) rather
        than hide it from scrapes that enforce the family's presence."""
        k = self._key(labels)
        with self._lock:
            self._values.setdefault(
                k, [[0] * len(self.buckets), 0.0, 0]
            )

    def observe(self, value: float, **labels) -> None:
        v = float(value)
        k = self._key(labels)
        with self._lock:
            st = self._values.get(k)
            if st is None:
                st = self._values[k] = [[0] * len(self.buckets), 0.0, 0]
            counts, _, _ = st
            for i, b in enumerate(self.buckets):
                if v <= b:
                    counts[i] += 1
                    break
            st[1] += v
            st[2] += 1

    def samples(self) -> List[str]:
        out = []
        with self._lock:
            for k, (counts, total, n) in sorted(self._values.items()):
                cum = 0
                for b, c in zip(self.buckets, counts):
                    cum += c
                    ls = self._label_str(k, (("le", _fmt_value(b)),))
                    out.append(f"{self.name}_bucket{ls} {cum}")
                ls = self._label_str(k, (("le", "+Inf"),))
                out.append(f"{self.name}_bucket{ls} {n}")
                out.append(
                    f"{self.name}_sum{self._label_str(k)} {_fmt_value(total)}"
                )
                out.append(f"{self.name}_count{self._label_str(k)} {n}")
        return out


class Registry:
    """Create-or-get metric families + scrape-time collectors.

    ``counter``/``gauge``/``histogram`` are idempotent: asking for an
    existing name returns the existing instrument (schema-checked), so
    repeated component construction (tests, engine restarts) composes
    instead of colliding.
    """

    def __init__(self):
        self._lock = threading.Lock()
        # insertion-ordered
        self._metrics: Dict[str, _Metric] = {}  # guarded_by: _lock
        self._collectors: List[Callable[[], None]] = []  # guarded_by: _lock
        self._collector_errors = 0  # guarded_by: _lock

    def _get_or_create(self, cls, name: str, help: str, labelnames, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if type(m) is not cls or m.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{m.kind} with labels {m.labelnames}"
                    )
                return m
            m = cls(name, help, labelnames=labelnames, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  buckets: Optional[Sequence[float]] = None,
                  labelnames: Sequence[str] = ()) -> Histogram:
        return self._get_or_create(
            Histogram, name, help, labelnames, buckets=buckets
        )

    def register_collector(self, fn: Callable[[], None]) -> None:
        """``fn()`` runs at every ``render()`` and snapshots component
        stats into this registry's instruments.  A collector that
        raises is counted (``mlcomp_metrics_collector_errors_total``)
        and skipped — a broken component must not take /metrics down
        with it."""
        with self._lock:
            self._collectors.append(fn)

    def unregister_collector(self, fn: Callable[[], None]) -> None:
        """Remove a registered collector (no-op if absent): a closed
        component (a MetricsHistory sampler) must not keep publishing
        frozen values — or pin itself alive — through a registry that
        outlives it."""
        with self._lock:
            try:
                self._collectors.remove(fn)
            except ValueError:
                pass

    def collect(self) -> None:
        """Run every registered collector once (error-contained) so the
        instruments hold fresh values — the shared first half of
        ``render`` and ``snapshot``."""
        with self._lock:
            collectors = list(self._collectors)
        for fn in collectors:
            try:
                fn()
            except Exception:
                with self._lock:
                    self._collector_errors += 1
        with self._lock:
            errs = self._collector_errors
        if errs:
            self.counter(
                "mlcomp_metrics_collector_errors_total",
                "Collector callbacks that raised during a scrape",
            ).set_total(errs)

    def snapshot(self, run_collectors: bool = True
                 ) -> Dict[str, Dict[str, Any]]:
        """Structured point-in-time read of every family: name ->
        ``{"kind", "labelnames", "buckets" (histograms), "values"}``
        where values maps labelset tuples to floats or histogram
        ``[counts, sum, count]`` triples.  The metrics-history sampler
        reads this instead of parsing the text exposition."""
        if run_collectors:
            self.collect()
        with self._lock:
            metrics = list(self._metrics.values())
        return {
            m.name: {
                "kind": m.kind,
                "labelnames": m.labelnames,
                "buckets": list(getattr(m, "buckets", ())) or None,
                "values": m.data(),
                "label_key": m.label_key,
            }
            for m in metrics
        }

    def render(self) -> str:
        self.collect()
        with self._lock:
            metrics = list(self._metrics.values())
        lines: List[str] = []
        for m in metrics:
            samples = m.samples()
            if not samples:
                continue
            if m.help:
                lines.append(f"# HELP {m.name} {_escape_help(m.help)}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            lines.extend(samples)
        return "\n".join(lines) + "\n"


_default = Registry()


def default_registry() -> Registry:
    """The process-wide registry (scheduler workers and anything
    without its own HTTP surface register here)."""
    return _default
