"""Route model + annotation-discovered route table; a copy of
``kubeflow_tpu/gateway/routing.py`` over the port's client.

Every Service that wants routing carries a ``kubeflow-tpu.org/gateway-route``
annotation (route spec {name, prefix, service, rewrite, ...}); the gateway
lists Services and keeps a longest-prefix route table.

The annotation is YAML as JAX's renderer writes it, or JSON as the port's
renderer writes it where PyYAML is absent (``manifests/core.py``'s
``dump_yaml``). With PyYAML every annotation is read as JAX reads it;
without it a JSON annotation is read by ``json`` and any other raises
:class:`ImportError` naming PyYAML, never "no routes".
"""

from __future__ import annotations

import hashlib
import json
import logging
import threading
from dataclasses import dataclass

from kubeflow_tpu_torch.k8s_client import K8sClient
from kubeflow_tpu_torch.manifests.core import GATEWAY_ROUTE_ANNOTATION

log = logging.getLogger(__name__)


def stable_hash01(key: bytes, salt: bytes = b"") -> float:
    """Deterministic uniform [0, 1) from a routing key — the same key
    maps to the same point on every gateway process forever (unlike
    Python's seeded ``hash``), so a canary split holds its assignment
    across gateway restarts and replicas."""
    h = hashlib.blake2b(salt + key, digest_size=8).digest()
    return int.from_bytes(h, "big") / 2.0**64


@dataclass(frozen=True)
class Route:
    name: str
    prefix: str
    service: str  # host:port (the primary backend)
    rewrite: str = "/"
    # Traffic splitting (the seldon abtest/mab/canary surface,
    # kubeflow/seldon/prototypes, core.libsonnet:305):
    # weighted variants — each request is routed to one backend drawn by
    # weight. Empty = all traffic to `service`.
    backends: tuple = ()  # ((host:port, weight), ...)
    # "weighted": static draw by weight. "epsilon-greedy": the seldon
    # multi-armed-bandit router (epsilon-greedy prototype) — explore a
    # random variant with probability epsilon, otherwise exploit the
    # best observed reward; rewards come from response status (5xx/
    # connect-fail = 0) or the admin feedback endpoint.
    # "prefix-affine": the replica-pool router — rendezvous-hash the
    # prompt's leading tokens over the healthy backends so requests
    # sharing a prefix land on ONE replica (its prefix cache keeps
    # hitting), spilling to the least-loaded backend when the affine
    # replica is over ``pressure`` in-flight requests.
    strategy: str = "weighted"
    epsilon: float = 0.1
    # prefix-affine knobs: leading tokens hashed into the routing key,
    # and the per-backend in-flight bound past which the affine pick
    # spills (0 = never spill).
    affinity_tokens: int = 32
    pressure: int = 0
    # KV-fill fraction past which the affine pick spills (0 = ignore).
    # The signal comes from the gateway's staleness-bounded scrape of
    # each backend's serving_kv_bytes_in_use/_total; an unscrapeable
    # backend contributes NO signal (never treated as empty).
    kv_pressure: float = 0.0
    # Disaggregated prefill pool: when non-empty, generate requests on
    # this route ride the two-hop relay — the gateway affine-picks a
    # prefill backend here, asks it to :prefill and push the prompt KV
    # to the chosen decode backend (one of ``backends``), then relays
    # the :predict to the decode backend as usual.
    prefill_backends: tuple = ()  # ((host:port, weight), ...)
    # "hash-split": the progressive-delivery strategy — version groups
    # (``splits``) each own a traffic weight, and a request is assigned
    # to a group by STABLE hash of its affinity key, so every request
    # sharing a prefix sees ONE model version (the per-request
    # rng.choices draw would interleave versions within a conversation
    # and poison both versions' prefix caches). Within the chosen
    # group the pick is rendezvous-affine, same as prefix-affine.
    splits: tuple = ()  # ((version, weight, (host:port, ...)), ...)
    # Shadow/mirror target: every request is also sent fire-and-forget to
    # this backend; its response is discarded and its failures invisible.
    shadow: str = ""
    # Fraction of requests mirrored to ``shadow``, decided by stable
    # hash of the affinity key (salted differently from the split hash
    # so shadow sampling doesn't correlate with version assignment).
    # 1.0 = mirror everything (the legacy behavior).
    shadow_fraction: float = 1.0
    # Outlier detection (seldon outlier-detector-v1alpha2 surface): score
    # each prediction request's feature against a running window;
    # |z| > threshold tags the response and counts into the outlier rate.
    # 0 disables.
    outlier_threshold: float = 0.0
    outlier_window: int = 100
    # Identity-token policy for this route: "" = the gateway default
    # (verify when a JwtVerifier is configured), "off" = this route is
    # exempt (the per-route face of iap.libsonnet:600's bypass_jwt),
    # "required" = bearer token only, no session fallback.
    jwt: str = ""
    # Per-tenant overload shedding: ((tenant, rate, burst), ...) token
    # buckets — a request whose tenant (X-Tenant header, else the
    # authenticated identity, else "default") is over rate answers 429
    # with a computed Retry-After at the GATEWAY, before any upstream
    # work. qos_default_rate/burst cover tenants without their own
    # entry (0 = unlimited). Bucket state lives on the Gateway, keyed
    # (route, tenant).
    qos_tenants: tuple = ()  # ((tenant, rate, burst), ...)
    qos_default_rate: float = 0.0
    qos_default_burst: float = 0.0

    def qos_for(self, tenant: str) -> tuple[float, float]:
        """(rate, burst) governing ``tenant`` on this route."""
        for name, rate, burst in self.qos_tenants:
            if name == tenant:
                return rate, burst
        return self.qos_default_rate, self.qos_default_burst

    @property
    def qos_active(self) -> bool:
        return bool(self.qos_tenants) or self.qos_default_rate > 0

    def pick_service(self, rng) -> str:
        if not self.backends:
            return self.service
        services = [b[0] for b in self.backends]
        weights = [b[1] for b in self.backends]
        return rng.choices(services, weights=weights)[0]

    def pick_split(self, key: bytes) -> tuple | None:
        """Assign a routing key to one version group by stable hash:
        the key's hash point falls into exactly one group's slice of
        the cumulative weight space. Returns ``(version, weight,
        backends)`` or None when the route has no splits."""
        if not self.splits:
            return None
        total = sum(s[1] for s in self.splits)
        if total <= 0:
            return self.splits[0]
        point = stable_hash01(key, b"split:") * total
        acc = 0.0
        for split in self.splits:
            acc += split[1]
            if point < acc:
                return split
        return self.splits[-1]

    def mirror_sample(self, key: bytes) -> bool:
        """Whether this request's key falls inside the shadow fraction
        (deterministic per key: an affine prefix is either always or
        never mirrored, so the candidate's prefix cache sees coherent
        conversations instead of random single turns)."""
        if self.shadow_fraction >= 1.0:
            return True
        if self.shadow_fraction <= 0.0:
            return False
        return stable_hash01(key, b"shadow:") < self.shadow_fraction

    def version_of(self, service: str) -> str:
        """The split version name owning ``service`` ("" if unsplit)."""
        for version, _w, members in self.splits:
            if service in members:
                return version
        return ""

    def target_for(self, path: str, service: str | None = None) -> str:
        """Rewrite `path` (which startswith prefix) onto the backend."""
        rest = path[len(self.prefix):]
        base = (self.rewrite if self.rewrite.endswith("/")
                else self.rewrite + "/")
        return ("http://" + (service or self.service) + base
                + rest.lstrip("/"))


def routes_from_service(svc: dict) -> list[Route]:
    raw = svc.get("metadata", {}).get("annotations", {}).get(
        GATEWAY_ROUTE_ANNOTATION
    )
    if not raw:
        return []
    try:
        import yaml
    except ImportError:
        yaml = None
    if yaml is None:
        try:
            specs = json.loads(raw)
        except ValueError:
            raise ImportError(
                f"the gateway-route annotation on "
                f"{svc['metadata'].get('name')} is not JSON; reading it "
                f"needs PyYAML, which is not installed",
                name="yaml") from None
    else:
        try:
            specs = yaml.safe_load(raw)
        except yaml.YAMLError:
            log.warning("bad route annotation on %s",
                        svc["metadata"].get("name"))
            return []
    if isinstance(specs, dict):
        specs = [specs]
    routes = []
    for spec in specs or []:
        try:
            backends = tuple(
                (b["service"], float(b.get("weight", 1)))
                for b in spec.get("backends", [])
            )
            if backends and any(w < 0 for _s, w in backends):
                raise ValueError("negative backend weight")
            if backends and not any(w > 0 for _s, w in backends):
                raise ValueError("all backend weights zero")
            service = spec.get("service") or (
                backends[0][0] if backends else None
            )
            if not service:
                raise KeyError("service")
            strategy = spec.get("strategy", "weighted")
            if strategy not in ("weighted", "epsilon-greedy",
                                "prefix-affine", "hash-split"):
                raise ValueError(f"unknown strategy {strategy!r}")
            splits = []
            seen_versions: set[str] = set()
            for s in spec.get("splits", []) or []:
                version = str(s.get("version", "")).strip()
                if not version:
                    raise ValueError("split missing version name")
                if version in seen_versions:
                    raise ValueError(
                        f"duplicate split version {version!r}")
                seen_versions.add(version)
                weight = float(s.get("weight", 0))
                if weight < 0:
                    raise ValueError("negative split weight")
                members = tuple(str(m) for m in s.get("backends", []))
                if not members:
                    raise ValueError(
                        f"split {version!r} has no backends")
                splits.append((version, weight, members))
            splits = tuple(splits)
            if splits and strategy != "hash-split":
                raise ValueError("splits requires the hash-split "
                                 "strategy")
            if strategy == "hash-split":
                if not splits:
                    raise ValueError("hash-split needs a splits list")
                if not any(w > 0 for _v, w, _m in splits):
                    raise ValueError("all split weights zero")
                if not spec.get("backends"):
                    # backends stays the flattened union across splits
                    # — health probing and the admin surface read it.
                    raise ValueError("hash-split needs a backends pool")
            shadow_fraction = float(spec.get("shadow_fraction", 1.0))
            if not 0.0 <= shadow_fraction <= 1.0:
                raise ValueError("shadow_fraction must be in [0, 1]")
            epsilon = float(spec.get("epsilon", 0.1))
            if not 0.0 <= epsilon <= 1.0:
                raise ValueError("epsilon must be in [0, 1]")
            affinity_tokens = int(spec.get("affinity_tokens", 32))
            if affinity_tokens < 1:
                raise ValueError("affinity_tokens must be >= 1")
            pressure = int(spec.get("pressure", 0))
            if pressure < 0:
                raise ValueError("pressure must be >= 0")
            kv_pressure = float(spec.get("kv_pressure", 0.0))
            if not 0.0 <= kv_pressure <= 1.0:
                raise ValueError("kv_pressure must be in [0, 1]")
            prefill_backends = tuple(
                (b["service"], float(b.get("weight", 1)))
                for b in spec.get("prefill_backends", [])
            )
            if prefill_backends and strategy != "prefix-affine":
                # The two-hop relay hashes the prompt; without the
                # affine strategy nothing reads the prefill pool.
                raise ValueError("prefill_backends requires the "
                                 "prefix-affine strategy")
            if strategy == "prefix-affine" and not spec.get("backends"):
                # One backend is nothing to hash over — surface the
                # misconfiguration instead of silently direct-routing.
                raise ValueError("prefix-affine needs a backends pool")
            outlier = spec.get("outlier", {}) or {}
            outlier_threshold = float(outlier.get("threshold", 0.0))
            outlier_window = int(outlier.get("window", 100))
            if outlier_threshold < 0:
                raise ValueError("outlier threshold must be >= 0")
            if outlier_window < 2:
                raise ValueError("outlier window must be >= 2")
            jwt = str(spec.get("jwt", ""))
            if jwt not in ("", "off", "required"):
                raise ValueError(f"jwt must be 'off' or 'required', "
                                 f"got {jwt!r}")
            qos = spec.get("qos", {}) or {}
            qos_tenants = tuple(
                (str(name),
                 float((t or {}).get("rate", 0)),
                 float((t or {}).get("burst", 0)))
                for name, t in sorted(
                    (qos.get("tenants", {}) or {}).items())
            )
            if any(r < 0 or b < 0 for _n, r, b in qos_tenants):
                raise ValueError("qos rate/burst must be >= 0")
            qos_default = qos.get("default", {}) or {}
            qos_default_rate = float(qos_default.get("rate", 0))
            qos_default_burst = float(qos_default.get("burst", 0))
            if qos_default_rate < 0 or qos_default_burst < 0:
                raise ValueError("qos default rate/burst must be >= 0")
            routes.append(Route(
                jwt=jwt,
                name=spec["name"], prefix=spec["prefix"],
                service=service, rewrite=spec.get("rewrite", "/"),
                backends=backends, strategy=strategy, epsilon=epsilon,
                affinity_tokens=affinity_tokens, pressure=pressure,
                kv_pressure=kv_pressure,
                prefill_backends=prefill_backends,
                splits=splits,
                shadow=spec.get("shadow", ""),
                shadow_fraction=shadow_fraction,
                outlier_threshold=outlier_threshold,
                outlier_window=outlier_window,
                qos_tenants=qos_tenants,
                qos_default_rate=qos_default_rate,
                qos_default_burst=qos_default_burst,
            ))
        except (KeyError, TypeError, ValueError) as e:
            log.warning("bad route spec in %s: %s",
                        svc["metadata"].get("name"), e)
    return routes


class RouteTable:
    """Longest-prefix route lookup, refreshed from Service annotations."""

    def __init__(self) -> None:
        self._routes: list[Route] = []
        self._lock = threading.Lock()

    def set_routes(self, routes: list[Route]) -> None:
        with self._lock:
            # Longest prefix first; on equal prefixes a split/shadow route
            # beats a plain one (a serving-route canary for a model must
            # override the model Service's own direct route, not lose the
            # tie to listing order), then name for determinism.
            self._routes = sorted(
                routes,
                key=lambda r: (-len(r.prefix),
                               0 if (r.backends or r.shadow) else 1,
                               r.name),
            )

    def refresh(self, client: K8sClient, namespace: str | None = None) -> int:
        routes = []
        for svc in client.list("v1", "Service", namespace):
            routes.extend(routes_from_service(svc))
        self.set_routes(routes)
        return len(routes)

    def match(self, path: str) -> Route | None:
        with self._lock:
            for r in self._routes:
                if path.startswith(r.prefix):
                    return r
        return None

    def snapshot(self) -> list[dict]:
        with self._lock:
            # Copies, not the live __dict__ of the frozen Routes — callers
            # (the admin handler) annotate these per request.
            return [dict(vars(r)) for r in self._routes]

    def find(self, name: str) -> Route | None:
        with self._lock:
            return next((r for r in self._routes if r.name == name), None)
