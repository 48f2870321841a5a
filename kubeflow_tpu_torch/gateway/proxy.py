"""The data-path request handler: routing, auth enforcement, backend
picks, streamed relay, retries, shadow mirroring, and upgrade tunnels; a
copy of ``kubeflow_tpu/gateway/proxy.py`` over the port's modules.

``make_proxy_handler(gw)`` builds the BaseHTTPRequestHandler class bound
to one :class:`kubeflow_tpu_torch.gateway.Gateway`. Streamed relay
(chunked re-encoding, SSE-safe flushing) and the HTTP/1.1 Upgrade TCP
tunnel live on the handler itself.
"""

from __future__ import annotations

import hashlib
import json
import socket
import threading
import time
import urllib.parse
from http.client import HTTPConnection
from http.server import BaseHTTPRequestHandler

from kubeflow_tpu_torch.gateway.resilience import OutlierStats
from kubeflow_tpu_torch.observability.tracing import (
    REQUEST_ID_HEADER,
    gen_request_id,
)
from kubeflow_tpu_torch.serving.affinity import (
    prefix_affinity_key,
    rendezvous_order,
)

# Hop-by-hop headers never forwarded (RFC 7230 §6.1).
_HOP_HEADERS = {
    "connection", "keep-alive", "proxy-authenticate",
    "proxy-authorization", "te", "trailers", "transfer-encoding", "upgrade",
    "host", "content-length",
}


def prompt_tokens_for(body: bytes | None) -> list | None:
    """The prompt token list out of a predict payload's first instance,
    or None when the body isn't one. Never raises — unparseable traffic
    simply carries no prompt."""
    if not body:
        return None
    try:
        payload = json.loads(body)
        inst = (payload.get("instances") or [None])[0] \
            if isinstance(payload, dict) else None
        toks = inst.get("tokens") if isinstance(inst, dict) else None
        if isinstance(toks, list) and toks:
            return toks
    except (ValueError, TypeError, UnicodeDecodeError):
        pass
    return None


def _affinity_head_bound(width: int) -> int:
    """How much of a long body the gateway buffers to compute an
    affinity key: room for the JSON scaffolding plus the leading
    ``width`` tokens the key actually hashes (~16 bytes per decimal
    token id is generous). Everything past the head spills to the
    backend unbuffered."""
    return max(4096, 16 * int(width) + 1024)


def leading_tokens_for(head: bytes, width: int) -> list | None:
    """Leading prompt tokens out of a TRUNCATED predict-payload head.
    ``json.loads`` rejects a cut-off body, but the affinity key only
    hashes the first ``width`` tokens — scan the head for the first
    ``"tokens"`` array and collect the integers that fit, so a long
    prompt routes to the SAME affine replica a short one with the same
    prefix does. Returns None (digest fallback) when no leading token
    run can be recovered. Never raises."""
    try:
        text = head.decode("utf-8", "ignore")
        idx = text.find('"tokens"')
        if idx < 0:
            return None
        start = text.find("[", idx)
        if start < 0:
            return None
        toks: list = []
        num = ""
        for ch in text[start + 1:]:
            if ch in "-0123456789":
                num += ch
            elif ch in ", \t\r\n]":
                if num:
                    toks.append(int(num))
                    num = ""
                    if len(toks) >= max(int(width), 1):
                        break
                if ch == "]":
                    break
            else:
                # Nested arrays / non-integer tokens: the strict parser
                # wouldn't have produced a token list either — fall back
                # to the digest key.
                return None
        return toks or None
    except (ValueError, OverflowError):
        return None


class _SpilledBody:
    """File-like request body for long payloads: the buffered head
    replays first, then the remainder streams straight from the client
    socket. ``http.client`` reads it in blocks, so the gateway never
    holds more than the head in memory. The caller must forward an
    explicit Content-Length of ``total_len`` (a file-like body without
    one would be re-encoded chunked, which plain CL-only backends
    don't speak)."""

    def __init__(self, head: bytes, rfile, remaining: int):
        self._head = head
        self._rfile = rfile
        self._remaining = max(int(remaining), 0)
        self.total_len = len(head) + self._remaining

    def read(self, n: int = -1) -> bytes:
        if n is None or n < 0:
            rest = (self._rfile.read(self._remaining)
                    if self._remaining else b"")
            out = self._head + rest
            self._head, self._remaining = b"", 0
            return out
        if self._head:
            out, self._head = self._head[:n], self._head[n:]
            return out
        if self._remaining <= 0:
            return b""
        data = self._rfile.read(min(n, self._remaining))
        self._remaining = self._remaining - len(data) if data else 0
        return data


def affinity_key_for(body: bytes | None, path: str, width: int) -> str:
    """Routing key for a prefix-affine route: the prompt's leading
    tokens when the body is a predict payload (requests sharing a
    prefix land on the same replica — the point), a digest of the raw
    body otherwise, the path for bodyless requests. Never raises —
    unparseable traffic still routes deterministically."""
    if body:
        toks = prompt_tokens_for(body)
        if toks is not None:
            return prefix_affinity_key(toks, width)
        return hashlib.blake2b(body[:1024], digest_size=8).hexdigest()
    return path


def make_proxy_handler(gw):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        # TCP_NODELAY on each client connection. Over TLS 1.3 the server
        # sends its session tickets after the handshake; with Nagle on,
        # the response's first segment then waits for the client's
        # delayed ACK of them (about 40 ms on Linux) on every new
        # connection.
        disable_nagle_algorithm = True

        def log_message(self, *a):
            pass

        def _respond(self, code: int, body: bytes,
                     headers: dict | None = None) -> None:
            self.send_response(code)
            rid = getattr(self, "_request_id", None)
            if rid:
                self.send_header(REQUEST_ID_HEADER, rid)
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            if headers is None or "Content-Type" not in headers:
                self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            if self.command != "HEAD":  # RFC 7231: HEAD has no body
                self.wfile.write(body)

        def _body_too_large(self, length: int) -> bool:
            """413 on a declared body beyond ``gw.max_body_bytes`` —
            BEFORE reading a byte of it, so an oversized long-context
            prompt costs the gateway a header parse, not a buffer."""
            if gw.max_body_bytes and length > gw.max_body_bytes:
                gw.errors_total += 1
                gw.body_rejected_total += 1
                self._respond(413, json.dumps(
                    {"error": f"request body {length} bytes exceeds "
                              f"max_body_bytes {gw.max_body_bytes}"}
                ).encode())
                self.close_connection = True  # unread body desyncs
                return True
            return False

        def _handle(self):
            gw.requests_total += 1
            # Request id: preserved when the client sent one, generated
            # otherwise — echoed on every response this gateway writes
            # and forwarded to the upstream, so one id follows the
            # request through gateway → server → decoder.
            self._request_id = (self.headers.get(REQUEST_ID_HEADER)
                                or gen_request_id())
            if self.path == "/healthz":
                self._respond(200, b'{"status":"ok"}')
                return
            if self.path.startswith("/.well-known/acme-challenge/"):
                token = self.path.rsplit("/", 1)[1]
                body = (gw.challenge_lookup(token)
                        if gw.challenge_lookup else None)
                if body is None:
                    self._respond(404, b'{"error":"unknown challenge"}')
                else:
                    self._respond(200, body.encode(),
                                  {"Content-Type": "text/plain"})
                return
            route = gw.table.match(self.path)
            if route is None:
                gw.errors_total += 1
                self._respond(
                    404,
                    json.dumps({"error": f"no route for {self.path}"})
                    .encode(),
                )
                return
            self._identity = None
            if route.jwt == "required" and gw.jwt_verifier is None:
                # Fail CLOSED: an operator demanded token checks on
                # this route but the gateway has no verifier — a
                # misconfiguration must not silently serve open.
                gw.errors_total += 1
                self._respond(503, json.dumps(
                    {"error": "route requires jwt but the gateway "
                              "has no verifier configured"}).encode())
                return
            if gw.jwt_verifier is not None and route.jwt != "off":
                claims, reason = gw.jwt_verifier.check(
                    self.command, self.path, self.headers
                )
                if claims is None:
                    # Browser sessions may still pass through
                    # forward-auth when it is configured (IAP serves
                    # both logins and SA id-tokens) — unless the
                    # route pins jwt: "required", which accepts
                    # nothing but a valid bearer token.
                    session_ok = (route.jwt != "required"
                                  and gw.auth_url
                                  and gw._authorized(self))
                    if not session_ok:
                        self._respond(401, json.dumps(
                            {"error": "unauthorized", "reason": reason}
                        ).encode(), {
                            "WWW-Authenticate":
                                f'Bearer error="{reason}"',
                            "Content-Type": "application/json",
                        })
                        return
                elif claims.get("sub"):
                    self._identity = str(claims["sub"])
            elif not gw._authorized(self):
                self._respond(
                    401, json.dumps({"error": "unauthorized",
                                     "login": "/login"}).encode(),
                )
                return
            # Overload shedding (multi-tenant QoS routes): an over-rate
            # tenant — or a fully saturated upstream pool — answers 429
            # + Retry-After HERE, before any upstream work, so overload
            # degrades to fast, actionable backpressure instead of a
            # queue collapsing behind the gateway. The tenant is the
            # X-Tenant header, else the authenticated identity, else
            # one implicit tenant.
            if route.qos_active:
                tenant = (self.headers.get("X-Tenant")
                          or self._identity or "default")
                ok, retry_after = gw.qos_admit(route, tenant)
                if not ok:
                    gw.qos_shed_total += 1
                    self._respond(429, json.dumps(
                        {"error": f"tenant {tenant!r} over admission "
                                  f"rate"}).encode(),
                        {"Retry-After":
                         str(max(1, int(retry_after + 0.999)))})
                    self.close_connection = True  # unread body desyncs
                    return
                if route.pressure > 0 and route.backends:
                    healthy = gw.health.filter_healthy(
                        [b[0] for b in route.backends])
                    if healthy and all(gw.load.depth(s) >= route.pressure
                                       for s in healthy):
                        # Every healthy backend is at its in-flight
                        # bound: queuing more here only stretches every
                        # tenant's tail. Retry-After 1s — depth drains
                        # on token timescales, not bucket refills.
                        gw.qos_shed_total += 1
                        self._respond(429, json.dumps(
                            {"error": "upstream pool saturated"}
                        ).encode(), {"Retry-After": "1"})
                        self.close_connection = True
                        return
            # Prefix-affine and hash-split routes hash the request BODY
            # (the prompt's leading tokens), so it must be read before
            # the pick — the other strategies keep the lazy read in
            # _proxy_http.
            body = None
            affinity_key = None
            if (route.strategy in ("prefix-affine", "hash-split")
                    and not self._is_upgrade()):
                try:
                    length = int(self.headers.get("Content-Length", 0))
                except ValueError:
                    gw.errors_total += 1
                    self._respond(400, json.dumps(
                        {"error": "malformed Content-Length"}).encode())
                    self.close_connection = True
                    return
                if self._body_too_large(length):
                    return
                bound = _affinity_head_bound(route.affinity_tokens)
                if length > bound:
                    # Long-context payload: hash only a bounded head for
                    # the backend pick and spill the remainder to the
                    # relay unbuffered — a multi-megabyte prompt must
                    # not be buffered (or JSON-parsed) at the gateway.
                    head = self.rfile.read(bound)
                    toks = leading_tokens_for(head, route.affinity_tokens)
                    affinity_key = (
                        prefix_affinity_key(toks, route.affinity_tokens)
                        if toks is not None else
                        hashlib.blake2b(head[:1024],
                                        digest_size=8).hexdigest())
                    body = _SpilledBody(head, self.rfile,
                                        length - len(head))
                else:
                    body = self.rfile.read(length) if length else b""
                    affinity_key = affinity_key_for(
                        body, self.path, route.affinity_tokens)
            service = self._pick_backend(route, key=affinity_key)
            if (route.prefill_backends and affinity_key is not None
                    and isinstance(body, bytes)
                    and self.path.endswith(":predict")):
                # Disaggregated two-hop: have the affine prefill
                # backend compute the prompt KV and push it to the
                # decode backend picked above, THEN relay the predict
                # there — where it prefix-hits the imported blocks.
                self._prefill_hop(route, body, affinity_key, service)
            target = route.target_for(self.path, service)
            # Re-point at the resolved backend address.
            target = target.replace(service, gw.resolve(service), 1)
            parts = urllib.parse.urlsplit(target)
            backend_path = parts.path + (
                "?" + parts.query if parts.query else ""
            )
            if self._is_upgrade():
                self._tunnel(route, parts.hostname, parts.port,
                             backend_path)
                return
            self._proxy_http(route, parts.hostname, parts.port,
                             backend_path, service, body=body)

        def _pick_backend(self, route, exclude: str | None = None,
                          key: str | None = None) -> str:
            """Choose a backend with ejected upstreams filtered out of
            the pick set (weighted draws, bandit arms, AND the
            rendezvous member set — the health machinery is how dead
            replicas leave the hash ring); ``exclude`` additionally
            drops the backend a retry just failed on."""
            if not route.backends:
                return route.service  # nowhere else to go
            services = gw.health.filter_healthy(
                [b[0] for b in route.backends]
            )
            if exclude and len(services) > 1:
                services = [s for s in services if s != exclude]
            if route.strategy == "prefix-affine":
                # Rendezvous placement: order[0] is the affine replica
                # for this key; excluding a dead/ejected backend remaps
                # ONLY its keys (survivors keep their order). Spill to
                # the least-loaded backend when the affine replica is
                # over the in-flight pressure bound OR its KV pool is
                # fuller than kv_pressure (staleness-bounded scrape;
                # no signal = no KV opinion, never "empty") — locality
                # yields to a real hotspot, and only then.
                order = rendezvous_order(key or self.path, services)
                picked = order[0]
                over_depth = (route.pressure > 0
                              and gw.load.depth(picked) >= route.pressure)
                fill = None
                if not over_depth and route.kv_pressure > 0:
                    fill = gw.kv_fill.fill(picked, gw.resolve)
                over_kv = (fill is not None
                           and fill >= route.kv_pressure)
                spill_kind = None
                if (over_depth or over_kv) and len(order) > 1:
                    # Directory-aware spill (fleet KV economy): prefer a
                    # backend already advertising this prefix — its trie
                    # (or peer-importable tier) is warm, so the spilled
                    # request pays a tail prefill instead of a full one.
                    # The directory only changes WHICH backend takes the
                    # spill, never WHETHER it happens: every candidate
                    # still has to actually relieve the pressure that
                    # triggered it (guards below), or the key stays home.
                    spill = None
                    if key is not None:
                        spill = next(
                            (h for h in gw.kv_directory.holders(key)
                             if h in order[1:]), None)
                        if spill is not None:
                            spill_kind = "directory"
                    if spill is None:
                        spill = gw.load.least_loaded(order[1:])
                        spill_kind = "spill"
                    if spill is not None and over_depth and \
                            gw.load.depth(spill) >= gw.load.depth(picked):
                        spill = None  # everyone is at least as deep
                    if spill is not None and over_kv:
                        sf = gw.kv_fill.fill(spill, gw.resolve)
                        if sf is not None and sf >= fill:
                            spill = None  # no less-full pool to go to
                    if spill is not None:
                        picked = spill
                        gw.affine_spills += 1
                    else:
                        spill_kind = None
                if key is not None:
                    gw.note_affinity(route.name, spill_kind or "affine")
                    # The picked backend is about to prefill (and pool)
                    # this prefix — advertise it so the NEXT spill of
                    # the same key prefers this backend over cold ones.
                    gw.kv_directory.publish(key, picked, tier="route")
            elif route.strategy == "hash-split":
                # Progressive delivery: the key's stable hash picks a
                # VERSION group (so an affine prefix sees exactly one
                # model version for the whole rollout), rendezvous
                # picks the replica within the group. Pressure spill
                # stays INSIDE the group — spilling across versions
                # would serve a conversation two different models and
                # corrupt the canary's latency comparison. A group
                # whose members are all unhealthy falls back to the
                # full healthy pool: serving the wrong version beats
                # serving 502s.
                split = route.pick_split((key or self.path).encode())
                members = set(split[2]) if split else set()
                group = [s for s in services if s in members] or services
                order = rendezvous_order(key or self.path, group)
                picked = order[0]
                if (route.pressure > 0
                        and gw.load.depth(picked) >= route.pressure
                        and len(order) > 1):
                    spill = gw.load.least_loaded(order[1:])
                    if (spill is not None
                            and gw.load.depth(spill)
                            < gw.load.depth(picked)):
                        picked = spill
                        gw.affine_spills += 1
            elif route.strategy == "epsilon-greedy":
                picked = gw.bandit.pick(route, gw.rng, services)
            else:
                weights = {b[0]: b[1] for b in route.backends}
                draw = [weights[s] for s in services]
                if not any(draw):  # only zero-weight backends left
                    draw = [1.0] * len(services)
                picked = gw.rng.choices(services, weights=draw)[0]
            # Consume the half-open trial only on the backend that
            # actually takes the request.
            gw.health.begin_trial(picked)
            return picked

        def _prefill_hop(self, route, body, key, decode_service) -> None:
            """Hop 1 of the disaggregated relay: POST ``:prefill`` at
            the affine prefill backend with ``handoff_to`` naming the
            decode backend, so the KV payload travels server-to-server
            and never transits the gateway. Best-effort — any failure
            just means the decode backend prefills the prompt itself
            (degraded, never wrong), so errors are counted, never
            surfaced to the client."""
            toks = prompt_tokens_for(body)
            if toks is None:
                return  # not a generate payload: nothing to hand off
            healthy = gw.health.filter_healthy(
                [b[0] for b in route.prefill_backends])
            if not healthy:
                gw.handoff_failures += 1
                return
            prefill_svc = rendezvous_order(key, healthy)[0]
            target = route.target_for(self.path, prefill_svc)
            target = target.replace(prefill_svc,
                                    gw.resolve(prefill_svc), 1)
            parts = urllib.parse.urlsplit(target)
            hop_path = parts.path.replace(":predict", ":prefill")
            payload = json.dumps({
                "instances": [{"tokens": toks}],
                "handoff_to": decode_service,
            }).encode()
            try:
                conn = HTTPConnection(parts.hostname, parts.port,
                                      timeout=gw.upstream_timeout)
                try:
                    conn.request(
                        "POST", hop_path, body=payload,
                        headers={"Content-Type": "application/json",
                                 REQUEST_ID_HEADER: self._request_id})
                    resp = conn.getresponse()
                    out = json.loads(resp.read() or b"{}")
                finally:
                    conn.close()
                if resp.status == 200 and out.get("handoff"):
                    gw.handoffs_total += 1
                    gw.health.record_success(prefill_svc)
                else:
                    gw.handoff_failures += 1
                    if resp.status >= 500:
                        gw.health.record_failure(prefill_svc)
            except (OSError, ValueError):
                gw.handoff_failures += 1
                gw.health.record_failure(prefill_svc)

        def _is_upgrade(self) -> bool:
            conn_tokens = [
                t.strip().lower()
                for t in self.headers.get("Connection", "").split(",")
            ]
            return ("upgrade" in conn_tokens
                    and bool(self.headers.get("Upgrade")))

        # -- plain HTTP: streamed relay -----------------------------

        def _proxy_http(self, route, host, port, path, service=None,
                        is_retry=False, body=None):
            # On a retry the request body stream is already consumed —
            # only bodyless idempotent methods reach here retrying.
            # ``body`` is pre-read when the route strategy needed it for
            # the backend pick (prefix-affine hashes the prompt).
            if body is None and not is_retry:
                try:
                    length = int(self.headers.get("Content-Length", 0))
                except ValueError:
                    # Malformed client header: answer 400 instead of
                    # dying with an uncaught traceback and a dropped
                    # connection.
                    gw.errors_total += 1
                    self._respond(400, json.dumps(
                        {"error": "malformed Content-Length"}).encode())
                    self.close_connection = True  # unread body desyncs
                    return
                if self._body_too_large(length):
                    return
                body = self.rfile.read(length) if length else None
            # Forwarded prefix and authenticated identity are
            # gateway-asserted — client-supplied copies must never
            # reach the backend (spoofing). The request id is gateway-
            # asserted too, but *preserves* the client's value.
            headers = {
                k: v for k, v in self.headers.items()
                if k.lower() not in _HOP_HEADERS
                and k.lower() not in ("x-forwarded-prefix",
                                      "x-auth-identity",
                                      "x-request-id")
            }
            headers["X-Forwarded-Prefix"] = route.prefix
            headers[REQUEST_ID_HEADER] = self._request_id
            # A spilled long body streams from the client socket; the
            # explicit Content-Length keeps http.client from falling
            # back to chunked re-encoding (which CL-only backends don't
            # speak). Body-inspection features below are skipped for it
            # — only the head ever existed in gateway memory.
            spilled = isinstance(body, _SpilledBody)
            if spilled:
                headers["Content-Length"] = str(body.total_len)
            if getattr(self, "_identity", None):
                # The x-goog-authenticated-user-email analogue.
                headers["X-Auth-Identity"] = self._identity
            version = (route.version_of(service)
                       if route.splits and service else "")
            if version and not is_retry:
                gw.version_requests.labels(route.name, version).inc()
            if route.shadow and not is_retry and not spilled:
                # Shadow sampling is decided by the same stable key the
                # split uses (different salt): a sampled-in prefix is
                # mirrored on every turn, so the candidate sees whole
                # conversations at shadow_fraction of the load.
                mkey = affinity_key_for(body, self.path,
                                        route.affinity_tokens)
                if route.mirror_sample(mkey.encode()):
                    self._mirror(route, path, body, dict(headers))
            tag_headers = {}
            if route.outlier_threshold > 0 and not is_retry \
                    and not spilled:
                value = OutlierStats.feature(body)
                if value is not None:
                    z, is_out = gw.outliers.score(
                        route.name, value,
                        window=route.outlier_window,
                        threshold=route.outlier_threshold,
                    )
                    tag_headers = {
                        "X-Outlier": "true" if is_out else "false",
                        "X-Outlier-Score": str(z),
                    }
            bandit = (route.strategy == "epsilon-greedy"
                      and service is not None)
            # Gateway-hop timeline (skipped on the retry re-entry — the
            # original request's timeline is still open upstack).
            tl = None if is_retry else gw.trace.start(self._request_id)
            if tl is not None:
                tl.event("received", route=route.name,
                         method=self.command, path=self.path)
            conn = HTTPConnection(host, port,
                                  timeout=gw.upstream_timeout)
            if service is not None:
                # Queue-depth accounting spans the WHOLE upstream
                # exchange (streamed relays included) — the pressure
                # signal prefix-affine spill decisions read.
                gw.load.acquire(service)
            try:
                t_up = time.perf_counter()
                try:
                    self._connect_upstream(conn)
                    conn.request(self.command, path, body=body,
                                 headers=headers)
                    resp = conn.getresponse()
                except OSError as e:
                    if tl is not None:
                        tl.event("upstream_failed",
                                 upstream=f"{host}:{port}")
                    if bandit:
                        gw.bandit.record(route.name, service, 0.0)
                    if service is not None:
                        gw.health.record_failure(service)
                    # Idempotent-GET retry: one shot at a DIFFERENT
                    # healthy backend, under the retry budget (a
                    # connect failure never duplicated a request).
                    if (self.command in ("GET", "HEAD")
                            and not is_retry
                            and route.backends
                            and service is not None
                            and gw._retry_allowed()):
                        retry_to = self._pick_backend(
                            route, exclude=service)
                        if retry_to != service:
                            gw.retries_total += 1
                            r_target = route.target_for(
                                self.path, retry_to)
                            r_target = r_target.replace(
                                retry_to, gw.resolve(retry_to), 1)
                            p = urllib.parse.urlsplit(r_target)
                            self._proxy_http(
                                route, p.hostname, p.port,
                                p.path + ("?" + p.query
                                          if p.query else ""),
                                retry_to, is_retry=True,
                            )
                            return
                    gw.errors_total += 1
                    self._respond(
                        502,
                        json.dumps(
                            {"error": f"upstream {host}:{port}: {e}"}
                        ).encode(),
                    )
                    return
                # Per-route upstream latency distribution (connect →
                # response headers): the autoscaler-facing signal.
                elapsed = time.perf_counter() - t_up
                gw.upstream_latency.labels(route.name).observe(elapsed)
                if version:
                    # Per-version distribution: the rollout gate's
                    # incumbent-vs-candidate comparison source.
                    gw.version_upstream_latency.labels(
                        route.name, version).observe(elapsed)
                if tl is not None:
                    tl.event("upstream_response", status=resp.status,
                             upstream=f"{host}:{port}")
                if bandit:
                    # Implicit reward: server errors are failures.
                    gw.bandit.record(route.name, service,
                                     0.0 if resp.status >= 500 else 1.0)
                if service is not None:
                    # Passive health observation: 5xx counts against
                    # the upstream; anything else closes its circuit.
                    if resp.status >= 500:
                        gw.health.record_failure(service)
                    else:
                        gw.health.record_success(service)
                self._relay_response(resp, tag_headers)
            finally:
                conn.close()
                if service is not None:
                    gw.load.release(service)
                if tl is not None:
                    tl.close()  # idempotent; covers the error returns too

        def _mirror(self, route, path, body, headers):
            """Fire-and-forget request mirror (seldon shadow/outlier
            surface): the shadow backend sees live traffic, its
            response is discarded, its failures never touch the
            client."""
            addr = gw.resolve(route.shadow)
            host, _, port_s = addr.partition(":")
            method = self.command
            headers["X-Shadow"] = "true"
            version = route.version_of(route.shadow) or "shadow"
            route_name = route.name

            def send():
                gw.shadow_total += 1
                gw.version_shadow_total.labels(route_name,
                                               version).inc()
                t0 = time.perf_counter()
                try:
                    conn = HTTPConnection(
                        host, int(port_s or 80),
                        timeout=gw.upstream_timeout,
                    )
                    conn.request(method, path, body=body,
                                 headers=headers)
                    conn.getresponse().read()
                    conn.close()
                    # Response discarded; its LATENCY is the point —
                    # the candidate's distribution under live load,
                    # before it takes a single user-visible request.
                    gw.version_upstream_latency.labels(
                        route_name, version).observe(
                        time.perf_counter() - t0)
                except (OSError, ValueError):
                    pass

            threading.Thread(target=send, daemon=True).start()

        def _connect_upstream(self, conn):
            """Connect with one retry — connect-phase only, so an
            in-flight request is never duplicated against a slow but
            alive upstream (ksonnet.go:147-168's retry role at the
            connection level)."""
            try:
                conn.connect()
            except OSError:
                conn.close()
                time.sleep(0.1)
                conn.connect()

        def _relay_response(self, resp, extra_headers=None):
            try:
                # Parse the upstream length BEFORE the status line goes
                # out: a malformed upstream Content-Length must become a
                # clean 502, which is impossible once bytes are written.
                upstream_len = resp.getheader("Content-Length")
                if upstream_len is not None:
                    try:
                        upstream_len = int(upstream_len)
                    except ValueError:
                        gw.errors_total += 1
                        self._respond(502, json.dumps(
                            {"error": "malformed upstream Content-Length"}
                        ).encode())
                        return
                self.send_response(resp.status)
                for k, v in resp.getheaders():
                    # The request id on the wire is gateway-asserted
                    # (same value the upstream echoed) — drop the
                    # upstream copy so the client never sees it twice.
                    if (k.lower() not in _HOP_HEADERS
                            and k.lower() != "x-request-id"):
                        self.send_header(k, v)
                rid = getattr(self, "_request_id", None)
                if rid:
                    self.send_header(REQUEST_ID_HEADER, rid)
                for k, v in (extra_headers or {}).items():
                    self.send_header(k, v)
                bodyless = (self.command == "HEAD"
                            or resp.status in (204, 304)
                            or 100 <= resp.status < 200)
                if bodyless or upstream_len is not None:
                    if upstream_len is not None:
                        self.send_header("Content-Length",
                                         str(upstream_len))
                    self.end_headers()
                    if not bodyless:
                        self._relay_known_length(resp, upstream_len)
                else:
                    self._relay_stream(resp)
                self.wfile.flush()
            except OSError:
                # Mid-stream failure: the status line is already gone;
                # drop the connection rather than corrupt the body.
                gw.errors_total += 1
                self.close_connection = True

        def _relay_known_length(self, resp, remaining: int) -> None:
            while remaining > 0:
                data = resp.read(min(65536, remaining))
                if not data:
                    # Upstream died short of its advertised length;
                    # the client was promised more bytes — drop the
                    # connection so it can't desync on a reuse.
                    gw.errors_total += 1
                    self.close_connection = True
                    return
                self.wfile.write(data)
                remaining -= len(data)

        def _relay_stream(self, resp) -> None:
            """Unknown upstream length (chunked/EOF-delimited):
            re-chunk and flush as data arrives so streaming bodies
            (SSE, token streams) are never buffered. HTTP/1.0 clients
            can't parse chunked — stream raw and close."""
            chunked = self.request_version != "HTTP/1.0"
            if chunked:
                self.send_header("Transfer-Encoding", "chunked")
            else:
                self.close_connection = True
            self.end_headers()
            while True:
                data = resp.read1(65536)
                if not data:
                    break
                if chunked:
                    self.wfile.write(
                        f"{len(data):x}\r\n".encode() + data + b"\r\n"
                    )
                else:
                    self.wfile.write(data)
                self.wfile.flush()
            if chunked:
                self.wfile.write(b"0\r\n\r\n")

        # -- HTTP/1.1 Upgrade: transparent TCP tunnel ---------------

        def _tunnel(self, route, host, port, path):
            """Forward the Upgrade handshake verbatim and then pump
            bytes both ways — the websocket path notebooks need
            (jupyter.libsonnet:97-106). The gateway never parses
            frames; after the handshake it is a plain TCP relay, so
            the backend's 101 (or its refusal) reaches the client
            unmodified."""
            try:
                backend = socket.create_connection(
                    (host, port), timeout=gw.upstream_timeout
                )
            except OSError as e:
                gw.errors_total += 1
                self._respond(
                    502,
                    json.dumps(
                        {"error": f"upstream {host}:{port}: {e}"}
                    ).encode(),
                )
                return
            gw.tunnels_total += 1
            lines = [f"{self.command} {path} HTTP/1.1",
                     f"Host: {host}:{port}",
                     f"X-Forwarded-Prefix: {route.prefix}",
                     f"{REQUEST_ID_HEADER}: {self._request_id}"]
            if getattr(self, "_identity", None):
                lines.append(f"X-Auth-Identity: {self._identity}")
            # Hop-by-hop headers are the handshake here — forward
            # everything except Host (rewritten above) and the
            # gateway-asserted headers (spoofing).
            lines += [
                f"{k}: {v}" for k, v in self.headers.items()
                if k.lower() not in ("host", "x-forwarded-prefix",
                                     "x-auth-identity", "x-request-id")
            ]
            try:
                backend.sendall(
                    ("\r\n".join(lines) + "\r\n\r\n").encode()
                )
                # Tunnel sockets outlive the 60s request timeout.
                backend.settimeout(None)
                self.connection.settimeout(None)
                done = threading.Event()

                def pump(read, write):
                    try:
                        while True:
                            data = read(65536)
                            if not data:
                                break
                            write(data)
                    except (OSError, ValueError):
                        pass
                    finally:
                        done.set()

                def write_client(data):
                    self.wfile.write(data)
                    self.wfile.flush()

                for read, write in (
                    (self.rfile.read1, backend.sendall),
                    (backend.recv, write_client),
                ):
                    threading.Thread(target=pump, args=(read, write),
                                     daemon=True).start()
                # First direction to close ends the tunnel; the
                # shutdown below unblocks the other pump.
                done.wait()
            finally:
                for s in (backend, self.connection):
                    try:
                        s.shutdown(socket.SHUT_RDWR)
                    except OSError:
                        pass
                backend.close()
                self.close_connection = True

        do_GET = do_POST = do_PUT = do_PATCH = do_DELETE = _handle
        do_HEAD = do_OPTIONS = _handle

    return Handler

