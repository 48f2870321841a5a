"""Multi-tenant QoS for the serving path: token-bucket admission,
weighted-fair + priority + deadline ordering, and bounded tenant labels.

A copy of ``kubeflow_tpu/serving/qos.py`` (pure host logic, no JAX), with
the two ordering primitives it takes from
``kubeflow_tpu/scheduler/queue.py`` (:func:`aged_priority`,
:func:`fairness_ratio`) copied in, so the port imports nothing of the
JAX package:

- :class:`TokenBucket` / :class:`QosPolicy` — per-tenant request-rate
  admission. An empty bucket rejects with a computed retry-after, so
  the model server answers 429 + ``Retry-After`` instead of queuing
  into collapse.
- :func:`order_key` — the pop-loop ordering: weighted fair share across
  tenants (lowest served/weight first) → effective priority with
  starvation aging → FIFO.
- :func:`tenant_bucket` — a stable hash of the tenant id into a BOUNDED
  label vocabulary (``t00``..``tNN``) so per-tenant histograms cannot
  explode exposition cardinality.
"""

from __future__ import annotations

import hashlib
import threading
from dataclasses import dataclass

# Default tenant id for requests that carry none: one implicit tenant,
# exactly the pre-QoS behavior.
DEFAULT_TENANT = "default"

# Bounded tenant-label cardinality for the exposition (tenant ids are
# user-controlled input; raw ids as label values would let one client
# mint unbounded metric families).
TENANT_LABEL_BUCKETS = 16


def aged_priority(priority: float, waited_seconds: float,
                  aging_seconds: float) -> float:
    """Effective priority after starvation aging: every
    ``aging_seconds`` of wait is worth one priority point, so a
    low-priority entry behind a stream of high-priority arrivals is
    eventually first in line. ``aging_seconds <= 0`` disables aging.
    (A copy of ``kubeflow_tpu/scheduler/queue.py:aged_priority``.)"""
    if aging_seconds <= 0:
        return float(priority)
    return float(priority) + max(waited_seconds, 0.0) / aging_seconds


def fairness_ratio(used_share: float, weight: float) -> float:
    """Weighted-fair ordering key: the tenant with the LOWEST
    used-share/weight ratio goes first, so service converges to the
    configured weights under backlog. (A copy of
    ``kubeflow_tpu/scheduler/queue.py:fairness_ratio``.)"""
    return float(used_share) / max(float(weight), 1e-9)


class DeadlineExceeded(TimeoutError):
    """A request's deadline passed before (or while) it could be
    served; the pop loop sheds it instead of spending decode compute on
    an answer nobody is waiting for. Subclasses TimeoutError so the
    HTTP layers map it to 503 like any other server-side timeout."""


class QosRejected(Exception):
    """Token-bucket admission refused the request. ``retry_after_s`` is
    the earliest time the tenant's bucket holds a token again — the
    HTTP layers answer 429 with a ``Retry-After`` header from it."""

    def __init__(self, tenant: str, retry_after_s: float):
        self.tenant = tenant
        self.retry_after_s = max(0.0, float(retry_after_s))
        super().__init__(
            f"tenant {tenant!r} over admission rate; "
            f"retry after {self.retry_after_s:.1f}s")


def tenant_bucket(tenant: str,
                  buckets: int = TENANT_LABEL_BUCKETS) -> str:
    """Stable bounded label value for a tenant id (``t00``..``tNN``).
    BLAKE2 (not ``hash()``) so gateway, server, and dashboards bucket
    identically across processes and runs."""
    h = hashlib.blake2b((tenant or DEFAULT_TENANT).encode("utf-8"),
                        digest_size=4).digest()
    return f"t{int.from_bytes(h, 'big') % buckets:02d}"


@dataclass
class TenantSpec:
    """One tenant's QoS contract.

    ``weight``: weighted-fair share of decode service (tokens) under
    backlog. ``rate``/``burst``: request-per-second token bucket
    (rate 0 = unlimited). ``priority``: default base priority for the
    tenant's requests (a per-request priority overrides it)."""

    name: str
    weight: float = 1.0
    rate: float = 0.0
    burst: float = 0.0
    priority: int = 0

    def __post_init__(self) -> None:
        if self.weight <= 0:
            raise ValueError(f"tenant {self.name!r}: weight must be > 0")
        if self.rate < 0 or self.burst < 0:
            raise ValueError(
                f"tenant {self.name!r}: rate/burst must be >= 0")


class TokenBucket:
    """Continuous-refill token bucket (monotonic timestamps passed in,
    so tests control the clock). ``rate`` tokens/second refill toward a
    ``burst`` capacity; a take when empty fails with the seconds until
    one token exists."""

    def __init__(self, rate: float, burst: float, now: float = 0.0):
        self.rate = float(rate)
        self.burst = max(float(burst) or max(self.rate, 1.0), 1.0)
        self._tokens = self.burst
        self._t = float(now)

    def try_take(self, now: float, cost: float = 1.0
                 ) -> tuple[bool, float]:
        """(admitted, retry_after_s). rate<=0 always admits."""
        if self.rate <= 0:
            return True, 0.0
        elapsed = max(now - self._t, 0.0)
        self._tokens = min(self.burst, self._tokens + elapsed * self.rate)
        self._t = now
        if self._tokens >= cost:
            self._tokens -= cost
            return True, 0.0
        return False, (cost - self._tokens) / self.rate


def parse_tenants(spec: str) -> dict[str, TenantSpec]:
    """Parse the CLI/manifest tenant string:
    ``name=weight[:rate[:burst[:priority]]]`` comma-separated, e.g.
    ``gold=8:100:200:10,free=1:10`` — the flat form the tpu-serving
    args carry (the CRD's structured ``spec.qos.tenants`` serializes
    to it). Raises ``ValueError`` on malformed entries so a typo fails
    at flag-parse time, not at the first misrouted request."""
    tenants: dict[str, TenantSpec] = {}
    for part in filter(None, (p.strip() for p in spec.split(","))):
        name, sep, rest = part.partition("=")
        name = name.strip()
        if not name or not sep:
            raise ValueError(f"malformed tenant spec {part!r} "
                             "(want name=weight[:rate[:burst[:prio]]])")
        fields = rest.split(":")
        if len(fields) > 4:
            raise ValueError(f"tenant {name!r}: too many fields in "
                             f"{rest!r}")
        try:
            nums = [float(f) for f in fields if f != ""]
        except ValueError:
            raise ValueError(
                f"tenant {name!r}: non-numeric field in {rest!r}"
            ) from None
        nums += [0.0] * (4 - len(nums))
        tenants[name] = TenantSpec(
            name=name, weight=nums[0] or 1.0, rate=nums[1],
            burst=nums[2], priority=int(nums[3]))
    return tenants


def render_tenants(tenants: dict) -> str:
    """Inverse of :func:`parse_tenants` for structured configs (the
    InferenceService operator turns ``spec.qos.tenants`` into the flat
    CLI string). Accepts ``{name: {weight, rate, burst, priority}}``."""
    parts = []
    for name in sorted(tenants):
        t = tenants[name] or {}
        parts.append(
            f"{name}={float(t.get('weight', 1) or 1):g}"
            f":{float(t.get('rate', 0) or 0):g}"
            f":{float(t.get('burst', 0) or 0):g}"
            f":{int(t.get('priority', 0) or 0)}")
    return ",".join(parts)


def order_key(*, served: float, weight: float, priority: float,
              waited_seconds: float, aging_seconds: float,
              submit_t: float) -> tuple:
    """Sort key for one pending request — ascending sort admits first.
    Three forces, strongest first (the scheduler queue's ordering
    applied to inference): weighted fair share across tenants,
    effective priority with starvation aging, FIFO tie-break."""
    return (fairness_ratio(served, weight),
            -aged_priority(priority, waited_seconds, aging_seconds),
            submit_t)


class QosPolicy:
    """Per-tenant admission + ordering policy for a decoder or gateway.

    Unknown tenants fall back to ``default`` (weight 1, unlimited rate,
    priority 0 unless a ``default`` entry overrides it). Bucket state
    is internally locked — submit runs on arbitrary caller threads."""

    def __init__(self, tenants: dict[str, TenantSpec] | str | None = None,
                 *, aging_seconds: float = 30.0):
        if isinstance(tenants, str):
            tenants = parse_tenants(tenants)
        self.tenants = dict(tenants or {})
        self.aging_seconds = float(aging_seconds)
        self._default = self.tenants.get(
            DEFAULT_TENANT, TenantSpec(DEFAULT_TENANT))
        self._buckets: dict[str, TokenBucket] = {}
        self._lock = threading.Lock()

    def spec(self, tenant: str) -> TenantSpec:
        return self.tenants.get(tenant or DEFAULT_TENANT, self._default)

    def base_priority(self, tenant: str, priority: int | None) -> int:
        """Request priority: explicit per-request value wins, else the
        tenant's default."""
        if priority is not None:
            return int(priority)
        return self.spec(tenant).priority

    def try_admit(self, tenant: str, now: float) -> tuple[bool, float]:
        """Token-bucket check for one request; (admitted, retry_after).
        Buckets are per tenant NAME (an unknown tenant gets its own
        bucket at the default spec's rate, so one abusive anonymous id
        cannot drain a shared bucket for everyone else)."""
        tenant = tenant or DEFAULT_TENANT
        spec = self.spec(tenant)
        if spec.rate <= 0:
            return True, 0.0
        with self._lock:
            bucket = self._buckets.get(tenant)
            if bucket is None:
                bucket = self._buckets[tenant] = TokenBucket(
                    spec.rate, spec.burst, now)
            return bucket.try_take(now)

    def admit(self, tenant: str, now: float) -> None:
        """:meth:`try_admit`, raising :class:`QosRejected` on refusal."""
        ok, retry = self.try_admit(tenant, now)
        if not ok:
            raise QosRejected(tenant or DEFAULT_TENANT, retry)
