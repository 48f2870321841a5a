"""API gateway: annotation-discovered reverse proxy; the port's copy of
``kubeflow_tpu/gateway/`` over the port's own modules.

Every Service that wants routing carries a ``kubeflow-tpu.org/gateway-route``
annotation (route spec {name, prefix, service, rewrite, ...}); the gateway
lists Services, keeps a longest-prefix route table and proxies each request
to a backend of its route: weighted, epsilon-greedy, prefix-affine (the
rendezvous pick the InferenceService controller's router annotation asks
for, with spill and the directory hint) or hash-split by version, with the
disaggregated two-hop relay (``:prefill`` with ``handoff_to``, then
``:predict``), shadow mirrors, outlier scoring, health ejection, QoS
shedding, forward auth and JWTs. Relays stream chunk by chunk and an
HTTP/1.1 Upgrade becomes a TCP tunnel.

The module names, classes, HTTP surface, headers, metric families and
routing decisions are JAX's. It is host code: it imports neither torch nor
JAX, so a gateway pod starts without either.
"""

from __future__ import annotations

import logging
import random
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable

from kubeflow_tpu_torch.gateway.admin import make_admin_handler
from kubeflow_tpu_torch.gateway.proxy import make_proxy_handler
from kubeflow_tpu_torch.observability.metrics import MetricRegistry
from kubeflow_tpu_torch.observability.tracing import TraceStore
from kubeflow_tpu_torch.serving.kv_directory import KvDirectory
from kubeflow_tpu_torch.gateway.resilience import (
    BackendLoad,
    BanditStats,
    KvFillCache,
    OutlierStats,
    UpstreamHealth,
)
from kubeflow_tpu_torch.gateway.routing import (
    Route,
    RouteTable,
    routes_from_service,
)

__all__ = [
    "BackendLoad", "BanditStats", "Gateway", "KvFillCache",
    "OutlierStats", "Route", "RouteTable", "UpstreamHealth",
    "routes_from_service",
]

log = logging.getLogger(__name__)


class Gateway:
    """The proxy + admin servers.

    ``resolve`` maps a route's `host:port` service address to the address to
    actually dial — identity in-cluster, overridden in tests to point at
    local fixture backends.
    """

    def __init__(
        self,
        table: RouteTable,
        *,
        port: int = 8080,
        admin_port: int = 8877,
        auth_url: str = "",
        resolve: Callable[[str], str] | None = None,
        certfile: str = "",
        keyfile: str = "",
        cert_reload_seconds: float = 5.0,
        redirect_port: int | None = None,
        redirect_target_port: int | None = None,
        challenge_lookup: Callable[[str], str | None] | None = None,
        upstream_timeout: float = 60.0,
        max_body_bytes: int = 0,
        health: UpstreamHealth | None = None,
        probe_interval: float = 2.0,
        retry_budget: float = 0.2,
        jwt_verifier=None,
        rng=None,
    ):
        self.table = table
        self.port = port
        self.admin_port = admin_port
        self.auth_url = auth_url
        self.resolve = resolve or (lambda addr: addr)
        self.upstream_timeout = upstream_timeout
        # Declared-request-size ceiling (0 = unbounded): a long-context
        # prompt larger than this answers 413 before any body byte is
        # read, so one oversized client can't balloon gateway memory.
        self.max_body_bytes = max_body_bytes
        self.body_rejected_total = 0
        # TLS termination at the gateway (the iap-ingress/cert-manager
        # role, kubeflow/gcp/iap.libsonnet): cert+key mounted from a
        # Secret; empty = plain HTTP (in-mesh or behind an LB). The
        # mounted files are WATCHED: when the certificate controller
        # rotates the secret, new handshakes pick up the new cert from
        # the same SSLContext without dropping the listener or any
        # established connection (cert_reload_seconds poll; 0 disables).
        self.certfile = certfile
        self.keyfile = keyfile
        self.cert_reload_seconds = cert_reload_seconds
        # components/https-redirect analogue: a plain-HTTP listener that
        # 301s every request to the HTTPS entrypoint. None = disabled.
        # ``redirect_target_port`` is the EXTERNALLY advertised HTTPS port
        # (None = omit, the :443 default) — behind a Service mapping
        # 443→bind-port, the bind port must never leak into Location.
        self.redirect_port = redirect_port
        self.redirect_target_port = redirect_target_port
        # ACME HTTP-01: serves /.well-known/acme-challenge/<token> from
        # the certificate controller's published challenges (the path a
        # letsencrypt-style validator fetches pre-issuance).
        self.challenge_lookup = challenge_lookup
        self.cert_reloads = 0
        # Weight-draw source for traffic splitting (seedable in tests).
        self.rng = rng or random.Random()
        # Reward averages for epsilon-greedy (bandit) routes.
        self.bandit = BanditStats()
        # Per-route anomaly scoring (seldon outlier-detector surface).
        self.outliers = OutlierStats()
        # Upstream health/circuit breaking: passive per-request
        # observations + an active prober thread (probe_interval; 0
        # disables the prober, passive observation still applies).
        self.health = health or UpstreamHealth()
        self.probe_interval = probe_interval
        # Idempotent-retry budget (envoy-style): GET/HEAD requests that
        # hit a dead backend may retry ONCE against a different healthy
        # backend, as long as retries stay under this fraction of
        # requests — a hard cap so retries can't amplify an outage.
        self.retry_budget = retry_budget
        # Identity-token verification (gateway/jwt_auth.JwtVerifier) —
        # the envoy jwt-auth filter role (iap.libsonnet:589-600). None =
        # no bearer-token requirement. When BOTH a verifier and a
        # forward-auth URL are configured, a request passes with EITHER a
        # valid token OR a valid session (IAP's browser-login + SA
        # id-token duality).
        self.jwt_verifier = jwt_verifier
        self.retries_total = 0
        self.requests_total = 0
        self.errors_total = 0
        self.tunnels_total = 0
        self.shadow_total = 0
        # Per-backend in-flight depth — the pressure signal the
        # prefix-affine replica-pool strategy spills on (exact for the
        # traffic this gateway carries; no scrape freshness to trust).
        self.load = BackendLoad()
        self.affine_spills = 0
        # Gateway-side KV-fill scrape (staleness-bounded): the replica
        # pool signal the in-flight depth can't see — a backend whose
        # block pool is nearly full defers admissions long before its
        # gateway-visible depth grows. Folded into the prefix-affine
        # spill decision when the route sets kv_pressure.
        self.kv_fill = KvFillCache()
        # Fleet KV economy: the gateway-side prefix→holder directory.
        # Every prefix-affine placement publishes its chosen backend as
        # a holder for the request's affinity key, and a SPILL consults
        # the directory first — a spilled request lands on a backend
        # already advertising its prefix (warm trie, or peer-importable
        # KV) instead of merely the least-loaded one. Hints, not truth:
        # the replicas validate on pull, so a stale gateway hint costs
        # one ordinary prefill.
        self.kv_directory = KvDirectory(2048)
        self.directory_hits = 0   # spills steered to an advertised holder
        # Per-route affinity outcome counters for the /metricsz rollup:
        # route name → {"affine": n, "spill": n, "directory": n}.
        self.route_affinity: dict = {}
        self._affinity_lock = threading.Lock()
        # Disaggregated two-hop relay counters (prefill_backends routes).
        self.handoffs_total = 0
        self.handoff_failures = 0
        # Per-tenant overload shedding (routes carrying a qos spec):
        # token buckets keyed (route, tenant), and how many requests
        # were answered 429 + Retry-After instead of queued into a
        # collapsing upstream.
        self.qos_shed_total = 0
        self._qos_buckets: dict = {}
        self._qos_lock = threading.Lock()
        # Shared observability registry (served on the admin /metrics):
        # per-route upstream latency distributions — the signal a
        # metric-driven autoscaler reads per backend pool.
        self.registry = MetricRegistry()
        self.upstream_latency = self.registry.histogram(
            "gateway_upstream_latency_seconds",
            "Upstream request latency (connect to response headers)",
            labels=("route",))
        # Progressive-delivery families: request counts, shadow-mirror
        # counts, and upstream-latency distributions labeled by model
        # version — the per-version evidence a rollout gate compares
        # (candidate p99 vs incumbent p99 on the SAME exposition).
        self.version_requests = self.registry.counter(
            "gateway_version_requests_total",
            "Requests routed per model version on a split route",
            labels=("route", "version"))
        self.version_shadow_total = self.registry.counter(
            "gateway_version_shadow_mirrors_total",
            "Shadow requests mirrored per model version",
            labels=("route", "version"))
        self.version_upstream_latency = self.registry.histogram(
            "gateway_version_upstream_latency_seconds",
            "Upstream request latency per model version "
            "(shadow mirrors included)",
            labels=("route", "version"))
        # Per-request timelines (received → upstream → relayed), ring-
        # bounded, served at the admin /debug/requests. The request id
        # recorded here is the same X-Request-ID forwarded upstream, so
        # a gateway hop and its decoder stream correlate by one id.
        self.trace = TraceStore()
        self._proxy: ThreadingHTTPServer | None = None
        self._admin: ThreadingHTTPServer | None = None
        self._redirect: ThreadingHTTPServer | None = None
        self._ssl_ctx = None      # the listener's context
        self._tls_current = None  # the newest loaded; handshakes move to it
        self._cert_watch_stop = threading.Event()

    def note_affinity(self, route_name: str, kind: str) -> None:
        """Count one prefix-affine placement outcome on a route:
        ``affine`` (landed on the rendezvous pick), ``spill`` (pressure
        pushed it off), or ``directory`` (a spill steered to a backend
        the prefix directory advertised). The /metricsz rollup reads
        these per route — spills were previously only visible
        per-replica."""
        with self._affinity_lock:
            per = self.route_affinity.setdefault(
                route_name, {"affine": 0, "spill": 0, "directory": 0})
            per[kind] = per.get(kind, 0) + 1
            if kind == "directory":
                self.directory_hits += 1

    def _retry_allowed(self) -> bool:
        return (self.retries_total + 1) <= self.retry_budget * max(
            self.requests_total, 1
        )

    def qos_admit(self, route, tenant: str) -> tuple[bool, float]:
        """Token-bucket admission for one request on a qos-carrying
        route: (admitted, retry_after_s). Buckets refill continuously
        at the route's per-tenant rate; an unknown tenant gets its own
        bucket at the route default (so one abusive id cannot drain a
        shared bucket for everyone else)."""
        from kubeflow_tpu_torch.serving.qos import TokenBucket

        rate, burst = route.qos_for(tenant)
        if rate <= 0:
            return True, 0.0
        now = time.monotonic()
        with self._qos_lock:
            bucket = self._qos_buckets.get((route.name, tenant))
            if bucket is None:
                bucket = self._qos_buckets[(route.name, tenant)] = \
                    TokenBucket(rate, burst, now)
            return bucket.try_take(now)

    # -- auth ---------------------------------------------------------------

    def _authorized(self, handler: BaseHTTPRequestHandler) -> bool:
        if not self.auth_url:
            return True
        req = urllib.request.Request(self.auth_url, method="GET")
        cookie = handler.headers.get("Cookie")
        if cookie:
            req.add_header("Cookie", cookie)
        auth = handler.headers.get("Authorization")
        if auth:
            req.add_header("Authorization", auth)
        try:
            with urllib.request.urlopen(req, timeout=5) as resp:
                return 200 <= resp.status < 300
        except urllib.error.HTTPError:
            return False
        except OSError:
            return False

    # -- proxy --------------------------------------------------------------

    def _probe_upstreams(self) -> None:
        """Active prober loop: every route backend (split variants AND
        single-backend services) gets a liveness probe per interval, so
        a dead upstream is ejected — and a recovered one readmitted via
        the half-open walk — without client traffic discovering it."""
        while not self._cert_watch_stop.wait(self.probe_interval):
            services: set[str] = set()
            for r in self.table.snapshot():
                services.add(r["service"])
                services.update(b[0] for b in r.get("backends", ()))
            try:
                self.health.probe(sorted(services), self.resolve)
            except Exception:  # pragma: no cover — probe must never die
                log.exception("upstream probe pass failed")

    def _load_tls(self):
        """A server context holding the cert/key files as they are now."""
        import ssl

        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.load_cert_chain(self.certfile, self.keyfile or None)
        return ctx

    def _pick_tls(self, sslobj, server_name, ctx) -> None:
        """The listener's SNI callback, which OpenSSL calls on every
        handshake (``server_name`` None without SNI): move the handshake
        onto the newest loaded context."""
        current = self._tls_current
        if current is not ctx:
            sslobj.context = current

    def _watch_certs(self) -> None:
        """Poll the cert/key files; on change, load them into a NEW
        SSLContext and make it the one new handshakes take (``_pick_tls``)
        — they present the rotated certificate while the listener and
        every established connection stay up (the rotation contract the
        certificate controller relies on). Reloading into the live
        context instead fails the handshakes that land mid-load: OpenSSL
        drops the context's key while a new certificate does not match
        it."""
        import os

        def stamp():
            try:
                return (os.stat(self.certfile).st_mtime_ns,
                        os.stat(self.keyfile).st_mtime_ns
                        if self.keyfile else 0)
            except OSError:
                return None

        last = stamp()
        while not self._cert_watch_stop.wait(self.cert_reload_seconds):
            now = stamp()
            if now is None or now == last:
                continue
            try:
                self._tls_current = self._load_tls()
                self.cert_reloads += 1
                last = now
                log.info("TLS certificate reloaded from %s (reload %d)",
                         self.certfile, self.cert_reloads)
            except (OSError, ValueError):
                # Mid-rotation read (cert/key momentarily mismatched):
                # keep serving the previous pair; next poll retries.
                pass

    def _make_redirect_handler(gw: "Gateway"):
        class Redirect(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def _redirect(self):
                host = (self.headers.get("Host") or "").split(":")[0]
                if not host:
                    # No Host → no valid Location to build.
                    self.send_response(400)
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return
                target = gw.redirect_target_port
                port = "" if target in (None, 443) else f":{target}"
                self.send_response(301)
                self.send_header("Location",
                                 f"https://{host}{port}{self.path}")
                self.send_header("Content-Length", "0")
                self.end_headers()

            do_GET = do_POST = do_PUT = do_DELETE = do_HEAD = _redirect

        return Redirect

    def start(self) -> None:
        self._proxy = ThreadingHTTPServer(
            ("0.0.0.0", self.port), make_proxy_handler(self)
        )
        self.port = self._proxy.server_address[1]  # resolve port 0
        if self.certfile:
            self._ssl_ctx = self._tls_current = self._load_tls()
            self._ssl_ctx.sni_callback = self._pick_tls
            self._proxy.socket = self._ssl_ctx.wrap_socket(
                self._proxy.socket, server_side=True
            )
            if self.cert_reload_seconds > 0:
                threading.Thread(target=self._watch_certs,
                                 daemon=True).start()
        threading.Thread(target=self._proxy.serve_forever,
                         daemon=True).start()
        if self.redirect_port is not None:
            self._redirect = ThreadingHTTPServer(
                ("0.0.0.0", self.redirect_port),
                self._make_redirect_handler(),
            )
            self.redirect_port = self._redirect.server_address[1]
            threading.Thread(target=self._redirect.serve_forever,
                             daemon=True).start()
        if self.admin_port:
            self._admin = ThreadingHTTPServer(
                ("0.0.0.0", self.admin_port), make_admin_handler(self)
            )
            threading.Thread(target=self._admin.serve_forever,
                             daemon=True).start()
        if self.probe_interval > 0:
            threading.Thread(target=self._probe_upstreams,
                             daemon=True).start()

    def stop(self) -> None:
        self._cert_watch_stop.set()
        for httpd in (self._proxy, self._admin, self._redirect):
            if httpd:
                httpd.shutdown()
