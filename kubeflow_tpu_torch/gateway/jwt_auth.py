"""Per-route JWT verification at the gateway (the envoy ``jwt-auth``
filter role: issuer, audiences, jwks_uri, the assertion header, the
bypass path list); a copy of ``kubeflow_tpu/gateway/jwt_auth.py`` over
the port's ``auth/tokens.py``.

:class:`JwksCache` pulls the issuer's key set and re-fetches on an
unknown ``kid`` (rate-limited), so the first token signed by a fresh key
triggers the refresh that admits it. :class:`JwtVerifier` is the
request-time policy: bearer tokens from ``Authorization`` or the
platform assertion header, verified for signature/issuer/audience/expiry
with clock skew, with a method+path bypass list.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request
from dataclasses import dataclass
from typing import Callable, Mapping

from kubeflow_tpu_torch.auth.tokens import (
    TokenError,
    decode_unverified,
    verify,
)

# The x-goog-iap-jwt-assertion analogue (iap.libsonnet:597): callers
# that need Authorization for the upstream put the platform token here.
ASSERTION_HEADER = "x-kubeflow-jwt-assertion"


@dataclass(frozen=True)
class BypassRule:
    """One `bypass_jwt` entry: method + exact path or prefix."""

    http_method: str = "GET"
    path_exact: str = ""
    path_prefix: str = ""

    def matches(self, method: str, path: str) -> bool:
        if self.http_method and method.upper() != self.http_method.upper():
            return False
        if self.path_exact:
            return path == self.path_exact
        return bool(self.path_prefix) and path.startswith(self.path_prefix)


class JwksCache:
    """Cached JWKS with unknown-kid refresh.

    ``source`` is either a URL (the gatekeeper's /.well-known/jwks.json)
    or a zero-arg callable returning the key-set dict (in-process tests,
    custom transports). A kid the cached set doesn't know gets an
    immediate re-fetch — a token signed by a freshly-rotated key must
    never see a 401 window — but each still-unknown kid is then remembered
    for ``min_refresh_seconds``, and miss-triggered fetches draw from a
    small per-window budget, so neither a replayed garbage token nor a
    flood of random kids can hammer the issuer (the envoy jwks
    cache-duration behavior).
    """

    MISS_FETCH_BUDGET = 5  # miss-triggered fetches per refresh window

    def __init__(self, source: str | Callable[[], Mapping], *,
                 refresh_seconds: float = 300.0,
                 min_refresh_seconds: float = 1.0,
                 clock: Callable[[], float] = time.monotonic):
        self._fetch = (source if callable(source)
                       else lambda: self._fetch_url(source))
        self.refresh_seconds = refresh_seconds
        self.min_refresh_seconds = min_refresh_seconds
        self.clock = clock
        self._lock = threading.Lock()
        self._jwks: dict = {"keys": []}
        self._fetched_at = float("-inf")
        self._attempted_at = float("-inf")  # last attempt, incl. failures
        self._inflight = False
        self._miss_at: dict[str, float] = {}  # kid -> last miss-fetch time
        self._miss_window_start = float("-inf")
        self._miss_budget = self.MISS_FETCH_BUDGET
        self.fetches = 0
        self.fetch_errors = 0

    @staticmethod
    def _fetch_url(url: str) -> dict:
        with urllib.request.urlopen(url, timeout=5) as resp:
            return json.loads(resp.read())

    def _has_kid(self, kid: str) -> bool:
        return any(k.get("kid") == kid for k in self._jwks["keys"])

    def jwks(self, *, want_kid: str | None = None) -> dict:
        """Current key set; stale or kid-missing sets are re-fetched.

        The HTTP fetch happens OUTSIDE the lock and at most one request
        performs it at a time — a slow or dead issuer costs one in-flight
        prober, never the whole data path. Failed attempts advance the
        attempt clock, so a down issuer is retried at most once per
        ``min_refresh_seconds`` on the staleness path.
        """
        with self._lock:
            now = self.clock()
            stale = (now - self._fetched_at > self.refresh_seconds
                     and now - self._attempted_at
                     > self.min_refresh_seconds)
            missing = want_kid is not None and not self._has_kid(want_kid)
            if missing:
                # Per-kid miss memory: the first sighting of a kid
                # re-fetches (zero-downtime rotation); a repeat of a kid
                # the issuer doesn't know waits out the window, and the
                # per-window budget caps what a flood of RANDOM kids can
                # trigger (a real rotation needs exactly one).
                last = self._miss_at.get(want_kid, float("-inf"))
                if now - last <= self.min_refresh_seconds:
                    missing = False
                else:
                    if (now - self._miss_window_start
                            > self.min_refresh_seconds):
                        self._miss_window_start = now
                        self._miss_budget = self.MISS_FETCH_BUDGET
                    if self._miss_budget <= 0:
                        missing = False
                    else:
                        self._miss_budget -= 1
            if (not stale and not missing) or self._inflight:
                return self._jwks
            self._inflight = True
            self._attempted_at = now
            self.fetches += 1
        ok, jwks = False, {}
        try:
            jwks = dict(self._fetch())
            ok = isinstance(jwks.get("keys"), list)
        except (OSError, ValueError):
            # Keep serving the cached set — verification degrades only
            # for tokens signed by keys we have never seen.
            pass
        with self._lock:
            self._inflight = False
            if ok:
                self._jwks = jwks
                self._fetched_at = self.clock()
            else:
                self.fetch_errors += 1
            if want_kid is not None and not self._has_kid(want_kid):
                if len(self._miss_at) > 1024:  # bound the memory
                    self._miss_at = {
                        k: t for k, t in self._miss_at.items()
                        if now - t <= self.min_refresh_seconds
                    }
                self._miss_at[want_kid] = now
            return self._jwks


class JwtVerifier:
    """The gateway's per-request token check."""

    def __init__(self, jwks: JwksCache | str | Callable[[], Mapping], *,
                 issuer: str, audience: str,
                 bypass: tuple[BypassRule, ...] = (),
                 skew_seconds: float = 60.0,
                 now: Callable[[], float] | None = None):
        self.cache = jwks if isinstance(jwks, JwksCache) else JwksCache(jwks)
        self.issuer = issuer
        self.audience = audience
        self.bypass = tuple(bypass)
        self.skew_seconds = skew_seconds
        self.now = now
        self.verified_total = 0
        self.rejected_total = 0

    def bypassed(self, method: str, path: str) -> bool:
        path = path.partition("?")[0]  # match on the path, not the query
        return any(r.matches(method, path) for r in self.bypass)

    @staticmethod
    def token_from_headers(headers: Mapping) -> str | None:
        assertion = headers.get(ASSERTION_HEADER)
        if assertion:
            return assertion.strip()
        authz = headers.get("Authorization") or ""
        if authz.startswith("Bearer "):
            return authz[7:].strip()
        return None

    def check(self, method: str, path: str,
              headers: Mapping) -> tuple[dict | None, str]:
        """(claims, "") when the request may pass; (None, reason) when it
        must be rejected. Bypass paths pass with no claims."""
        if self.bypassed(method, path):
            return {}, ""
        token = self.token_from_headers(headers)
        if not token:
            self.rejected_total += 1
            return None, "missing-token"
        # Route on the (unverified) kid so a fresh key triggers exactly
        # one JWKS re-fetch; verification then runs on the cached set.
        try:
            kid = decode_unverified(token)[0].get("kid")
        except TokenError:
            kid = None
        try:
            claims = verify(
                token, self.cache.jwks(want_kid=kid),
                issuer=self.issuer, audience=self.audience,
                now=self.now() if self.now else None,
                skew_seconds=self.skew_seconds,
            )
        except TokenError as e:
            self.rejected_total += 1
            return None, str(e)
        self.verified_total += 1
        return claims, ""


def bypass_from_specs(specs) -> tuple[BypassRule, ...]:
    """Parse `[{http_method, path_exact | path_prefix}, ...]` (the
    iap.libsonnet:600 bypass_jwt shape; JSON string accepted)."""
    if isinstance(specs, str):
        specs = json.loads(specs) if specs.strip() else []
    rules = []
    for spec in specs or []:
        rules.append(BypassRule(
            http_method=str(spec.get("http_method", "GET")),
            path_exact=str(spec.get("path_exact", "")),
            path_prefix=str(spec.get("path_prefix", "")),
        ))
    return tuple(rules)
