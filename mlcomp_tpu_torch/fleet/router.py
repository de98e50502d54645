"""The fleet's HTTP front door: prefix-affinity load balancing (the port's copy of
mlcomp_tpu/fleet/router.py).

One replica's host prefix cache (and paged COW registry) is only worth
its RAM if requests sharing a prefix keep landing on it — a blind
round-robin would spread a hot system prompt across every replica and
turn each copy cold.  The router therefore hashes the prompt's leading
token ids with the SAME key the cache walks (``cache/prefix_key.py``)
and rendezvous-hashes that key over the replica set:

- **affinity**: the HRW winner gets the request when it is live, ready,
  and unsaturated — deterministic across router restarts (the hash is
  seeded by content, not process state) and minimally disturbed by
  replica churn (HRW moves only the keys that hashed to the changed
  member).
- **least-loaded fallback**: a saturated (recent 429 or deep queue) or
  unhealthy affinity target forfeits to the lowest ``queue_depth``
  live replica — the depth read straight from the ``/healthz`` polls.
- **passthrough semantics**: ``traceparent`` is forwarded (or minted)
  so ONE trace id follows the request router→replica and
  ``/fleet/trace`` shows both sides; SSE bodies stream through
  token-by-token; a replica's 429 body and ``Retry-After`` header pass
  back verbatim (the drain estimate was computed where the queue is).
- **failure handling**: a connection error BEFORE any response byte is
  relayed marks the replica down immediately (no waiting for the next
  poll round) and retries the request on the next-ranked live replica;
  mid-stream failures terminate that stream with an SSE error event —
  the bounded client-visible cost of losing a replica.

Discovery is pluggable: an in-process :class:`ReplicaManager`, the
JSON registry file (fleet/registry.py) for a router in its own
process, or a static URL list.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from mlcomp_tpu_torch.cache.prefix_key import (
    DEFAULT_AFFINITY_TOKENS,
    prefix_hash,
    rendezvous_rank,
)
from mlcomp_tpu_torch.fleet.manager import fetch_json
from mlcomp_tpu_torch.fleet.registry import read_registry
from mlcomp_tpu_torch.utils.trace import make_trace_id

ROUTE_REASONS = ("affinity", "least_loaded", "retry")
OUTCOMES = ("ok", "rejected", "upstream_error", "no_replica", "error")
PHASES = ("both", "prefill", "decode")

# headers relayed replica -> client verbatim (plus x-mlcomp-replica,
# which the router adds)
_RELAY_HEADERS = ("Content-Type", "Retry-After", "Cache-Control")


class _RState:
    __slots__ = (
        "name", "url", "ok", "ready", "queue_depth", "fails",
        "saturated_until", "ever_polled", "phase",
    )

    def __init__(self, name: str, url: str):
        self.name = name
        self.url = url
        self.ok = False
        self.ready = False
        self.queue_depth = 0
        self.fails = 0
        self.saturated_until = 0.0
        self.ever_polled = False
        self.phase = "both"  # disaggregation role, from /healthz

    def live(self, unhealthy_after: int) -> bool:
        return self.ok and self.ready and self.fails < unhealthy_after

    def saturated(self, now: float) -> bool:
        return now < self.saturated_until

    def snapshot(self, now: float, unhealthy_after: int
                 ) -> Dict[str, Any]:
        return {
            "name": self.name, "url": self.url, "ok": self.ok,
            "ready": self.ready, "queue_depth": self.queue_depth,
            "live": self.live(unhealthy_after),
            "saturated": self.saturated(now),
            "phase": self.phase,
        }


def _name_for(url: str) -> str:
    return url.split("://", 1)[-1].rstrip("/")


class _ConnPool:
    """Keep-alive upstream connections, per (host, port).

    The router's measured ceiling was connection SETUP: every proxied
    request opened a fresh TCP connection (and the HTTP/1.0 daemons
    closed it after one response), so the proxy path paid a handshake
    per request.  The serve daemons now speak HTTP/1.1, and this pool
    parks drained connections for reuse — ``acquire`` pops an idle
    socket or dials a new one, ``release`` parks it back only when the
    response was fully read and the peer didn't ask to close.

    ``MLCOMP_TPU_ROUTER_POOL=0`` disables reuse (every acquire dials,
    every release closes) — the bisect arm of bench's fleet
    requests-per-second probe."""

    def __init__(self, enabled: bool = True, max_idle_per_host: int = 8,
                 timeout_s: float = 660.0):
        self.enabled = bool(enabled)
        self.max_idle = int(max_idle_per_host)
        self.timeout_s = float(timeout_s)
        self._lock = threading.Lock()
        self._idle: Dict[Tuple[str, int], List[Any]] = {}
        self.opens = 0
        self.reuses = 0

    def acquire(self, host: str, port: int):
        import http.client

        if self.enabled:
            with self._lock:
                idle = self._idle.get((host, port))
                if idle:
                    conn = idle.pop()
                    self.reuses += 1
                    return conn
        with self._lock:
            self.opens += 1
        return http.client.HTTPConnection(
            host, port, timeout=self.timeout_s
        )

    def release(self, conn, host: str, port: int,
                reusable: bool) -> None:
        if not (self.enabled and reusable):
            conn.close()
            return
        with self._lock:
            idle = self._idle.setdefault((host, port), [])
            if len(idle) < self.max_idle:
                idle.append(conn)
                return
        conn.close()

    def close(self) -> None:
        with self._lock:
            conns = [c for idle in self._idle.values() for c in idle]
            self._idle.clear()
        for c in conns:
            c.close()

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            idle = sum(len(v) for v in self._idle.values())
        return {
            "enabled": self.enabled, "idle": idle,
            "opens": self.opens, "reuses": self.reuses,
        }


class Router:
    """Routing brain + health poller; the HTTP shell lives in
    :func:`make_router_http_server`."""

    def __init__(
        self,
        manager=None,
        registry_path: Optional[str] = None,
        urls: Optional[List[str]] = None,
        metrics=None,
        affinity_tokens: int = DEFAULT_AFFINITY_TOKENS,
        saturation_queue_depth: int = 8,
        health_poll_s: float = 0.5,
        health_timeout_s: float = 2.0,
        unhealthy_after: int = 2,
        saturated_cooldown_s: float = 2.0,
        proxy_timeout_s: float = 660.0,
        clock: Callable[[], float] = time.monotonic,
        fetch: Callable[..., Dict[str, Any]] = fetch_json,
    ):
        if manager is None and registry_path is None and not urls:
            raise ValueError(
                "Router needs a discovery source: a ReplicaManager, a "
                "registry_path, or a static urls list"
            )
        # one manager, or a LIST of them — a phase-split fleet runs a
        # prefill set and a decode set side by side, each reconciled
        # by its own ReplicaManager, discovered by this one router
        self.manager = manager
        self.managers = (
            list(manager) if isinstance(manager, (list, tuple))
            else [manager] if manager is not None else []
        )
        self.registry_path = registry_path
        self.static_urls = [u.rstrip("/") for u in (urls or [])]
        self.affinity_tokens = int(affinity_tokens)
        self.saturation_queue_depth = int(saturation_queue_depth)
        self.health_poll_s = float(health_poll_s)
        self.health_timeout_s = float(health_timeout_s)
        self.unhealthy_after = int(unhealthy_after)
        self.saturated_cooldown_s = float(saturated_cooldown_s)
        self.proxy_timeout_s = float(proxy_timeout_s)
        self._clock = clock
        self._fetch = fetch
        self._lock = threading.Lock()
        self._replicas: Dict[str, _RState] = {}  # guarded_by: _lock
        self._decisions: deque = deque(maxlen=256)  # guarded_by: _lock
        self._counts = {  # guarded_by: _lock
            "outcome": {k: 0 for k in OUTCOMES},
            "reason": {k: 0 for k in ROUTE_REASONS},
            "upstream_retries": 0,
            # disaggregated two-hop accounting: handoffs brokered
            # (prefill blob fetched, delivered, and ACCEPTED by a
            # decode replica), failures (rejected at delivery, or a
            # hop exhausted its retries), and the blob bytes moved
            # through the router
            "handoffs": 0,
            "handoff_failures": 0,
            "handoff_bytes": 0,
        }
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # upstream keep-alive pool (MLCOMP_TPU_ROUTER_POOL=0 disables
        # — the bisect arm of bench's router RPS probe)
        self.pool = _ConnPool(
            enabled=os.environ.get(
                "MLCOMP_TPU_ROUTER_POOL", "1"
            ).strip().lower() not in ("0", "false"),
            timeout_s=self.proxy_timeout_s,
        )
        self.metrics = metrics
        self._hist_handoff = None
        if metrics is not None:
            from mlcomp_tpu_torch.obs.metrics import DEFAULT_MS_BUCKETS

            self._hist_handoff = metrics.histogram(
                "mlcomp_fleet_router_handoff_ms",
                "Wall ms per brokered handoff (prefill hop + decode "
                "delivery, host-bounce through the router)",
                buckets=DEFAULT_MS_BUCKETS,
            )
            # render the empty family from birth: a monolithic fleet
            # brokers no handoffs, but the scrape contract
            # (obs_check's DOCUMENTED_FLEET_METRICS) still sees it
            self._hist_handoff.touch()
            metrics.register_collector(self._collect_metrics)

    # ------------------------------------------------------------ control

    def start(self) -> None:
        if self._thread is not None:
            return
        self.poll_once()
        self._thread = threading.Thread(
            target=self._run, name="fleet-router-health", daemon=True
        )
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.health_poll_s + 10.0)
            self._thread = None
        self.pool.close()

    def _run(self) -> None:
        while not self._stop.wait(self.health_poll_s):
            try:
                self.poll_once()
            except Exception:
                import logging

                logging.getLogger("mlcomp_tpu_torch.fleet").exception(
                    "router health poll failed"
                )

    # ---------------------------------------------------------- discovery

    def _discover(self) -> Dict[str, str]:
        """name -> url from the configured source."""
        if self.managers:
            return {
                r["name"]: r["url"].rstrip("/")
                for m in self.managers
                for r in m.replicas() if r.get("url")
            }
        if self.registry_path is not None:
            return {
                name: str(e["url"]).rstrip("/")
                for name, e in read_registry(self.registry_path).items()
                if e.get("url")
            }
        return {_name_for(u): u for u in self.static_urls}

    def poll_once(self) -> None:
        """One discovery + health round (the tests' lever)."""
        found = self._discover()
        with self._lock:
            for name in list(self._replicas):
                if name not in found:
                    del self._replicas[name]
            for name, url in found.items():
                r = self._replicas.get(name)
                if r is None or r.url != url:
                    self._replicas[name] = _RState(name, url)
            targets = list(self._replicas.values())

        def poll_one(r):
            try:
                return r, self._fetch(
                    r.url, "/healthz", timeout=self.health_timeout_s
                )
            except Exception:
                return r, None

        from mlcomp_tpu_torch.fleet.manager import _fetch_all

        for r, hz in _fetch_all(targets, poll_one):
            with self._lock:
                if self._replicas.get(r.name) is not r:
                    continue  # replaced mid-poll
                r.ever_polled = True
                if hz is None:
                    r.ok = False
                    r.fails += 1
                    continue
                r.ok = bool(hz.get("ok"))
                r.ready = bool(hz.get("ready", r.ok))
                r.queue_depth = int(hz.get("queue_depth") or 0)
                phase = hz.get("phase")
                if phase in PHASES:
                    r.phase = phase
                r.fails = 0 if r.ok else r.fails + 1

    def mark_down(self, name: str) -> None:
        """Immediate markdown on an observed connection failure — the
        next poll round can resurrect it."""
        with self._lock:
            r = self._replicas.get(name)
            if r is not None:
                r.ok = False
                r.fails = max(r.fails, self.unhealthy_after)

    def mark_saturated(self, name: str) -> None:
        with self._lock:
            r = self._replicas.get(name)
            if r is not None:
                r.saturated_until = (
                    self._clock() + self.saturated_cooldown_s
                )

    # ------------------------------------------------------------ routing

    def affinity_key(self, prompt_ids) -> Optional[str]:
        try:
            if not prompt_ids:
                return None
            return prefix_hash(prompt_ids, self.affinity_tokens)
        except (TypeError, ValueError):
            return None

    def phase_split_active(self) -> bool:
        """True when the fleet holds BOTH a live prefill replica and a
        live decode replica: fresh prompts then route through the
        two-hop handoff path (prefill -> pages -> decode) instead of a
        single monolithic replica."""
        with self._lock:
            states = list(self._replicas.values())
        live = {
            r.phase for r in states if r.live(self.unhealthy_after)
        }
        return "prefill" in live and "decode" in live

    def choose(self, key: Optional[str],
               exclude: Tuple[str, ...] = (),
               phase: Optional[str] = None) -> Tuple[
                   Optional[Dict[str, str]], str]:
        """Pick ``(replica {name,url}, reason)`` for an affinity key.

        ``phase`` filters the candidate pool: ``"prefill"`` /
        ``"decode"`` pick that role exactly (the two hops of a
        handoff); None — the single-hop default — admits everything
        EXCEPT prefill replicas, which own no decode loop.  The same
        affinity key ranks both hops, so a prompt's prefix keeps
        warming one prefill replica's caches and one decode replica's
        page registry.

        The HRW ranking runs over ALL known replica names — not just
        the live ones — so a replica's keys come back to it the moment
        it rejoins instead of being permanently re-homed."""
        now = self._clock()
        with self._lock:
            states = list(self._replicas.values())
        if phase is None:
            states = [r for r in states if r.phase != "prefill"]
        else:
            states = [r for r in states if r.phase == phase]
        candidates = [
            r for r in states
            if r.live(self.unhealthy_after) and r.name not in exclude
        ]
        if not candidates:
            return None, "no_live_replica"
        by_name = {r.name: r for r in candidates}
        if key is not None:
            # the HRW winner over ALL known replicas — not just the
            # live ones — is THE affinity target: while it is down its
            # keys serve from the least-loaded fallback, and the moment
            # it rejoins they come home instead of staying re-homed
            rank = rendezvous_rank(
                key, sorted(r.name for r in states)
            )
            target = by_name.get(rank[0]) if rank else None
            if target is not None and not target.saturated(now) and (
                target.queue_depth < self.saturation_queue_depth
            ):
                return (
                    {"name": target.name, "url": target.url}, "affinity"
                )
        pool = [r for r in candidates if not r.saturated(now)]
        if not pool:
            pool = candidates
        pick = min(pool, key=lambda r: (r.queue_depth, r.name))
        return {"name": pick.name, "url": pick.url}, "least_loaded"

    def record(self, outcome: str, reason: Optional[str] = None,
               replica: Optional[str] = None,
               trace_id: Optional[str] = None,
               retried: bool = False) -> None:
        with self._lock:
            if outcome in self._counts["outcome"]:
                self._counts["outcome"][outcome] += 1
            if reason in self._counts["reason"]:
                self._counts["reason"][reason] += 1
            if retried:
                self._counts["upstream_retries"] += 1
            self._decisions.append({
                "t_unix": time.time(), "outcome": outcome,
                "reason": reason, "replica": replica,
                "trace_id": trace_id,
            })

    def record_handoff(self, ok: bool, nbytes: int = 0,
                       wall_ms: Optional[float] = None) -> None:
        with self._lock:
            if ok:
                self._counts["handoffs"] += 1
                self._counts["handoff_bytes"] += int(nbytes)
            else:
                self._counts["handoff_failures"] += 1
        if ok and wall_ms is not None and self._hist_handoff is not None:
            self._hist_handoff.observe(wall_ms)

    # ------------------------------------------------------------ reading

    def status(self) -> Dict[str, Any]:
        now = self._clock()
        with self._lock:
            reps = [
                r.snapshot(now, self.unhealthy_after)
                for r in self._replicas.values()
            ]
            decisions = list(self._decisions)[-16:]
            counts = {
                "outcome": dict(self._counts["outcome"]),
                "reason": dict(self._counts["reason"]),
                "upstream_retries": self._counts["upstream_retries"],
                "handoffs": self._counts["handoffs"],
                "handoff_failures": self._counts["handoff_failures"],
                "handoff_bytes": self._counts["handoff_bytes"],
            }
        by_phase = {p: 0 for p in PHASES}
        for r in reps:
            if r["live"]:
                by_phase[r.get("phase", "both")] += 1
        return {
            "ok": True,
            "role": "router",
            "replicas": sorted(reps, key=lambda r: r["name"]),
            "live": sum(1 for r in reps if r["live"]),
            "live_by_phase": by_phase,
            "phase_split": (
                by_phase["prefill"] > 0 and by_phase["decode"] > 0
            ),
            "counts": counts,
            "decisions": decisions,
            "conn_pool": self.pool.stats(),
            "health_poll_s": self.health_poll_s,
        }

    def _collect_metrics(self) -> None:
        m = self.metrics
        with self._lock:
            counts = {
                "outcome": dict(self._counts["outcome"]),
                "reason": dict(self._counts["reason"]),
                "retries": self._counts["upstream_retries"],
                "handoffs": self._counts["handoffs"],
                "handoff_failures": self._counts["handoff_failures"],
                "handoff_bytes": self._counts["handoff_bytes"],
            }
            live = sum(
                1 for r in self._replicas.values()
                if r.live(self.unhealthy_after)
            )
            by_phase = {p: 0 for p in PHASES}
            for r in self._replicas.values():
                if r.live(self.unhealthy_after):
                    by_phase[r.phase] += 1
        req = m.counter(
            "mlcomp_fleet_router_requests_total",
            "Requests through the router by outcome",
            labelnames=("outcome",),
        )
        for k in OUTCOMES:
            req.set_total(counts["outcome"][k], outcome=k)
        routed = m.counter(
            "mlcomp_fleet_router_routed_total",
            "Routing decisions by reason (affinity = prefix-affinity "
            "target took it; least_loaded = fallback; retry = re-route "
            "after an upstream connection failure)",
            labelnames=("reason",),
        )
        for k in ROUTE_REASONS:
            routed.set_total(counts["reason"][k], reason=k)
        m.counter(
            "mlcomp_fleet_router_upstream_retries_total",
            "Requests re-sent to another replica after a connection "
            "failure before any response byte",
        ).set_total(counts["retries"])
        m.gauge(
            "mlcomp_fleet_router_replicas_live",
            "Replicas the router currently considers routable "
            "(ok AND ready)",
        ).set(live)
        phase_gauge = m.gauge(
            "mlcomp_fleet_replicas_live_by_phase",
            "Live replicas by disaggregation role (both = monolithic; "
            "prefill/decode = the phase-split halves)",
            labelnames=("phase",),
        )
        for p in PHASES:
            phase_gauge.set(by_phase[p], phase=p)
        m.counter(
            "mlcomp_fleet_router_handoffs_total",
            "Disaggregated handoffs brokered end to end (prefill blob "
            "fetched, delivered, and ACCEPTED by a decode replica)",
        ).set_total(counts["handoffs"])
        m.counter(
            "mlcomp_fleet_router_handoff_failures_total",
            "Handoffs that did not land: rejected at delivery (4xx/"
            "5xx relayed from the decode replica) or abandoned after "
            "exhausting a hop's retries",
        ).set_total(counts["handoff_failures"])
        m.counter(
            "mlcomp_fleet_router_handoff_bytes_total",
            "KV-page handoff bytes moved through the router "
            "(host-bounce transfer size)",
        ).set_total(counts["handoff_bytes"])
        pool = self.pool.stats()
        m.counter(
            "mlcomp_fleet_router_conn_reuses_total",
            "Upstream keep-alive connection reuses "
            "(MLCOMP_TPU_ROUTER_POOL=0 pins this at 0)",
        ).set_total(pool["reuses"])
        m.counter(
            "mlcomp_fleet_router_conn_opens_total",
            "Upstream TCP connections dialed",
        ).set_total(pool["opens"])


# ------------------------------------------------------------------ HTTP


def make_router_http_server(router: Router, host: str = "127.0.0.1",
                            port: int = 0) -> "ThreadingHTTPServer":
    """The router's HTTP shell (stdlib, threaded — one handler thread
    per in-flight proxied request, like the serve daemon itself).

    Routes: ``POST /generate`` (proxied with affinity), ``GET /healthz``
    (the router's own status + per-replica view), ``GET /metrics``
    (Prometheus exposition of the shared fleet registry).

    When the fleet is PHASE-SPLIT (a live prefill replica AND a live
    decode replica), a ``/generate`` lands as the two-hop handoff:
    hop 1 POSTs the request to a prefill replica's ``/prefill`` and
    reads back the KV-page handoff blob; hop 2 delivers the blob to a
    decode replica's ``/import`` and relays that response (streaming
    included) to the client.  The SAME affinity key ranks both hops,
    so a shared prefix keeps warming one prefill replica's host cache
    and one decode replica's page registry.  A prefill replica dying
    mid-transfer surfaces as a short read of the blob — the router
    retries hop 1 on the next prefill replica (the survivor path,
    chaoscheck scenario 10); when no prefill replica can serve, the
    request falls back to the monolithic single-hop path.

    All upstream requests ride the router's keep-alive
    :class:`_ConnPool` (the serve daemons speak HTTP/1.1); a parked
    socket that died between requests is retried once on a fresh
    dial before any replica is blamed."""
    import hmac
    import http.client
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    from urllib.parse import urlsplit

    class Handler(BaseHTTPRequestHandler):
        # HTTP/1.1 on the CLIENT side too: a load balancer that makes
        # its callers re-handshake per request would just move the
        # connection ceiling one hop downstream.  Every response sets
        # Content-Length; the SSE relay opts out with an explicit
        # Connection: close.
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):
            pass

        def _json(self, obj, code=200, headers=()):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            for k, v in headers:
                self.send_header(k, v)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _token_ok(self) -> bool:
            secret = os.environ.get("MLCOMP_TPU_SERVE_TOKEN", "")
            if not secret:
                return True
            auth = self.headers.get("Authorization", "")
            return hmac.compare_digest(auth, f"Bearer {secret}")

        def do_GET(self):  # noqa: N802
            if not self._token_ok():
                return self._json(
                    {"error": "invalid or missing token"}, 403
                )
            route = self.path.split("?", 1)[0]
            if route == "/healthz":
                return self._json(router.status())
            if route == "/metrics" and router.metrics is not None:
                from mlcomp_tpu_torch.obs.metrics import CONTENT_TYPE

                body = router.metrics.render().encode()
                self.send_response(200)
                self.send_header("Content-Type", CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return None
            return self._json({"error": "not found"}, 404)

        def do_POST(self):  # noqa: N802
            # early returns answer BEFORE the body was read: close the
            # connection so keep-alive peers don't parse the unread
            # body as their next request line
            if not self._token_ok():
                return self._json(
                    {"error": "invalid or missing token"}, 403,
                    headers=(("Connection", "close"),),
                )
            if self.path.split("?", 1)[0] != "/generate":
                return self._json(
                    {"error": "not found"}, 404,
                    headers=(("Connection", "close"),),
                )
            n = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(n)
            key = None
            want_stream = False
            try:
                req = json.loads(body or b"{}")
                key = router.affinity_key(req.get("prompt"))
                want_stream = bool(req.get("stream", False))
            except (ValueError, TypeError):
                pass  # malformed JSON: the replica's 400 is richer
            # one trace id follows the request router -> replica: the
            # client's traceparent forwards verbatim; absent one, the
            # router MINTS the id so even the retry hops share it
            traceparent = self.headers.get("traceparent")
            if traceparent is None:
                tid = make_trace_id()
                traceparent = f"00-{tid}-{os.urandom(8).hex()}-01"
            else:
                from mlcomp_tpu_torch.utils.trace import parse_traceparent

                tid = parse_traceparent(traceparent) or make_trace_id()
            if router.phase_split_active():
                if self._handoff(body, key, traceparent, tid,
                                 want_stream):
                    return None
                # the split collapsed mid-flight (every prefill
                # replica died between the check and the hop): fall
                # through to the monolithic path — choose() without a
                # phase never targets a prefill replica
            tried: List[str] = []
            reason = None
            while True:
                target, r = router.choose(key, exclude=tuple(tried))
                if target is None:
                    router.record(
                        "no_replica", reason, trace_id=tid,
                    )
                    return self._json(
                        {"error": "no live replica to route to",
                         "status": "no_replica", "trace_id": tid,
                         "tried": tried},
                        503, headers=(("Retry-After", "1"),),
                    )
                reason = "retry" if tried else r
                ok = self._proxy(
                    target, body, traceparent, tid, want_stream, reason
                )
                if ok:
                    return None
                tried.append(target["name"])

        def _upstream(self, url: str, path: str, body: bytes,
                      traceparent: str,
                      ctype: str = "application/json"):
            """One POST over a pooled keep-alive connection ->
            ``(conn, resp, host, port)``.  A PARKED socket that fails
            before any response byte is the keep-alive race (the peer
            closed it between requests), retried once on a fresh
            dial; a fresh dial's failure propagates to the caller."""
            sp = urlsplit(url)
            host, port = sp.hostname, sp.port
            headers = {
                "Content-Type": ctype,
                "Content-Length": str(len(body)),
                "traceparent": traceparent,
            }
            token = os.environ.get("MLCOMP_TPU_SERVE_TOKEN", "")
            if token:
                headers["Authorization"] = f"Bearer {token}"
            while True:
                conn = router.pool.acquire(host, port)
                fresh = getattr(conn, "sock", None) is None
                try:
                    conn.request("POST", path, body=body,
                                 headers=headers)
                    return conn, conn.getresponse(), host, port
                except (OSError, http.client.HTTPException):
                    conn.close()
                    if fresh:
                        raise

        def _release(self, conn, resp, host, port) -> None:
            """Park a fully-drained connection for reuse (the peer
            didn't ask to close), else close it."""
            router.pool.release(
                conn, host, port,
                reusable=not getattr(resp, "will_close", True),
            )

        def _proxy(self, target, body, traceparent, tid, want_stream,
                   reason, path: str = "/generate",
                   ctype: str = "application/json"):
            """Forward to one replica.  False = connection failed
            before any response byte (caller retries elsewhere);
            otherwise the relayed HTTP status (truthy — the handoff
            path reads it to tell an ACCEPTED import from a relayed
            reject)."""
            try:
                conn, resp, up_host, up_port = self._upstream(
                    target["url"], path, body, traceparent, ctype,
                )
            except (OSError, http.client.HTTPException):
                router.mark_down(target["name"])
                router.record(
                    "upstream_error", reason, replica=target["name"],
                    trace_id=tid, retried=True,
                )
                return False
            reusable = False
            try:
                resp_ctype = resp.getheader("Content-Type", "")
                streaming = "text/event-stream" in resp_ctype
                payload = b""
                if not streaming:
                    # read the WHOLE body before the first byte goes to
                    # the client: a replica dying mid-response is then
                    # still a clean retry on another replica instead of
                    # a torn half-written client response
                    try:
                        payload = resp.read()
                    except (OSError, http.client.HTTPException):
                        router.mark_down(target["name"])
                        router.record(
                            "upstream_error", reason,
                            replica=target["name"], trace_id=tid,
                            retried=True,
                        )
                        return False
                if resp.status == 429:
                    # the replica's admission verdict stands: relay the
                    # body AND Retry-After verbatim, and steer the next
                    # requests elsewhere for a cooldown
                    router.mark_saturated(target["name"])
                self.send_response(resp.status)
                for h in _RELAY_HEADERS:
                    v = resp.getheader(h)
                    if v is not None:
                        self.send_header(h, v)
                self.send_header("x-mlcomp-replica", target["name"])
                if streaming:
                    self.send_header("Connection", "close")
                    self.end_headers()
                    try:
                        while True:
                            chunk = resp.readline()
                            if not chunk:
                                break
                            self.wfile.write(chunk)
                            if chunk == b"\n":
                                self.wfile.flush()
                    except (OSError, http.client.HTTPException):
                        # mid-stream upstream loss: terminate THIS
                        # stream with an error event — the bounded
                        # client-visible failure of losing a replica
                        router.mark_down(target["name"])
                        err = json.dumps({
                            "error": "upstream replica lost mid-stream",
                            "status": "upstream_lost",
                            "trace_id": tid,
                            "replica": target["name"],
                        })
                        try:
                            self.wfile.write(
                                f"data: {err}\n\n".encode()
                            )
                            self.wfile.flush()
                        except OSError:
                            pass
                        router.record(
                            "upstream_error", reason,
                            replica=target["name"], trace_id=tid,
                        )
                        return resp.status
                else:
                    self.send_header(
                        "Content-Length", str(len(payload))
                    )
                    self.end_headers()
                    self.wfile.write(payload)
                    reusable = True  # body fully read above
                outcome = "ok"
                if resp.status == 429:
                    outcome = "rejected"
                elif resp.status >= 400:
                    outcome = "error"
                router.record(
                    outcome, reason, replica=target["name"],
                    trace_id=tid,
                )
                return resp.status
            except BrokenPipeError:
                # client went away; nothing to relay to
                return resp.status
            finally:
                if reusable:
                    self._release(conn, resp, up_host, up_port)
                else:
                    conn.close()

        def _hop_prefill(self, target, body, traceparent, tid,
                         reason):
            """Hop 1 of a handoff: POST the generate-shaped request to
            ``target``'s ``/prefill`` and read the whole blob.

            Returns ``("blob", bytes)`` on a 200; ``("relayed",)``
            when a non-200 verdict (429 backpressure, 4xx) was relayed
            to the client — the replica answered, its verdict stands;
            ``None`` when the connection failed or the blob came back
            SHORT (the replica died mid-transfer) — the caller marks
            it down and retries the next prefill replica."""
            try:
                conn, resp, up_host, up_port = self._upstream(
                    target["url"], "/prefill", body, traceparent,
                )
            except (OSError, http.client.HTTPException):
                router.mark_down(target["name"])
                return None
            try:
                try:
                    payload = resp.read()
                except (OSError, http.client.HTTPException):
                    # short read: Content-Length promised more bytes
                    # than arrived — the mid-transfer death
                    router.mark_down(target["name"])
                    return None
                if resp.status != 200:
                    if resp.status == 429:
                        router.mark_saturated(target["name"])
                    self.send_response(resp.status)
                    for h in _RELAY_HEADERS:
                        v = resp.getheader(h)
                        if v is not None:
                            self.send_header(h, v)
                    self.send_header(
                        "x-mlcomp-replica", target["name"]
                    )
                    self.send_header(
                        "Content-Length", str(len(payload))
                    )
                    self.end_headers()
                    try:
                        self.wfile.write(payload)
                    except OSError:
                        pass
                    router.record(
                        "rejected" if resp.status == 429 else "error",
                        reason, replica=target["name"],
                        trace_id=tid,
                    )
                    return ("relayed",)
                self._release(conn, resp, up_host, up_port)
                conn = None
                return ("blob", payload)
            finally:
                if conn is not None:
                    conn.close()

        def _handoff(self, body, key, traceparent, tid,
                     want_stream) -> bool:
            """The two-hop disaggregated path.  True = a response was
            sent to the client; False = no prefill replica could serve
            and nothing was sent (the caller falls back to the
            monolithic single-hop path)."""
            t0 = time.perf_counter()
            tried_p: List[str] = []
            blob = None
            while True:
                ptarget, p_r = router.choose(
                    key, exclude=tuple(tried_p), phase="prefill",
                )
                if ptarget is None:
                    if tried_p:
                        router.record_handoff(False)
                    return False
                p_reason = "retry" if tried_p else p_r
                hop = self._hop_prefill(
                    ptarget, body, traceparent, tid, p_reason,
                )
                if hop is None:
                    router.record(
                        "upstream_error", p_reason,
                        replica=ptarget["name"], trace_id=tid,
                        retried=True,
                    )
                    tried_p.append(ptarget["name"])
                    continue
                if hop[0] == "relayed":
                    return True
                blob = hop[1]
                break
            import_path = "/import" + (
                "?stream=1" if want_stream else ""
            )
            tried_d: List[str] = []
            while True:
                dtarget, r = router.choose(
                    key, exclude=tuple(tried_d), phase="decode",
                )
                if dtarget is None:
                    router.record_handoff(False)
                    router.record("no_replica", None, trace_id=tid)
                    self._json(
                        {"error": "handoff prefilled but no live "
                         "decode replica to import it",
                         "status": "no_replica", "trace_id": tid,
                         "tried": tried_d},
                        503, headers=(("Retry-After", "1"),),
                    )
                    return True
                reason = "retry" if tried_d else r
                status = self._proxy(
                    dtarget, blob, traceparent, tid, want_stream,
                    reason, path=import_path,
                    ctype="application/octet-stream",
                )
                if status:
                    # a relayed reject (429 no_free_pages, 400
                    # bad_handoff, 5xx) means the import did NOT
                    # land: count it as a handoff failure, not a
                    # brokered success — operators diff these two
                    # counters to judge the split's health
                    router.record_handoff(
                        status < 400, len(blob),
                        wall_ms=(time.perf_counter() - t0) * 1e3,
                    )
                    return True
                tried_d.append(dtarget["name"])

    return ThreadingHTTPServer((host, port), Handler)
