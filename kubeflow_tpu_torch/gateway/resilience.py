"""Upstream resilience: health/circuit breaking (with the ``/healthz``
"warming" probe), bandit routing, outlier scoring, in-flight depth and
the KV-fill scrape; a copy of ``kubeflow_tpu/gateway/resilience.py``.

``KvFillCache`` reads ``serving_kv_bytes_in_use`` and
``serving_kv_bytes_total`` from a backend's
``/monitoring/prometheus/metrics``, the names the port's model server
exports.
"""

from __future__ import annotations

import json
import threading
import time
import socket
from typing import TYPE_CHECKING, Callable

if TYPE_CHECKING:  # annotation-only: routing imports nothing from here
    from kubeflow_tpu_torch.gateway.routing import Route


class OutlierStats:
    """Route-attached anomaly scoring — the seldon outlier-detector
    variant (kubeflow/seldon/prototypes/
    outlier-detector-v1alpha2.jsonnet:1-128 attaches a Mahalanobis
    scorer to a model route). Platform recast: a running z-score over a
    scalar feature of each prediction request (mean |value| of the
    instances payload), maintained per route over a sliding window.
    Requests scoring beyond the route's threshold are tagged
    (X-Outlier/X-Outlier-Score response headers — the streamed relay
    never buffers bodies, so tagging rides headers) and counted into the
    outlier-rate metric."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # route -> (window deque, outliers, scored)
        self._windows: dict[str, object] = {}
        self._counts: dict[str, list[int]] = {}

    @staticmethod
    def feature(body: bytes | None) -> float | None:
        """Scalar feature of a prediction request: mean |x| over every
        numeric leaf of "instances". None = not scoreable (no/bad JSON,
        no numerics) — never an error, scoring must not break proxying."""
        if not body:
            return None
        try:
            payload = json.loads(body)
        except (ValueError, UnicodeDecodeError):
            return None
        total, n = 0.0, 0
        stack = [payload.get("instances")
                 if isinstance(payload, dict) else payload]
        while stack:
            node = stack.pop()
            if isinstance(node, bool):
                continue
            if isinstance(node, (int, float)):
                total += abs(float(node))
                n += 1
            elif isinstance(node, list):
                stack.extend(node)
            elif isinstance(node, dict):
                stack.extend(node.values())
        return total / n if n else None

    # Baseline points required before anything is flagged: a 2-sample
    # window's std is noise, and normal jitter would score "infinite".
    WARMUP = 10

    def score(self, route: str, value: float, *, window: int,
              threshold: float) -> tuple[float, bool]:
        """Running z-score of ``value`` against the route's window
        (scored BEFORE insertion, so one huge request can't mask
        itself); returns (score, is_outlier). Warmup requests build the
        baseline and are never flagged."""
        import collections
        import math

        with self._lock:
            win = self._windows.setdefault(
                route, collections.deque(maxlen=max(window, 2))
            )
            counts = self._counts.setdefault(route, [0, 0])
            if win.maxlen != max(window, 2):
                # Window reconfigured (annotation re-applied): carry the
                # most recent baseline into the new size.
                win = collections.deque(win, maxlen=max(window, 2))
                self._windows[route] = win
            warm = len(win) >= min(self.WARMUP, win.maxlen)
            if len(win) >= 2:
                mean = sum(win) / len(win)
                var = sum((v - mean) ** 2 for v in win) / len(win)
                std = math.sqrt(var)
                z = abs(value - mean) / std if std > 1e-12 else (
                    0.0 if abs(value - mean) < 1e-12 else float("inf")
                )
            else:
                z = 0.0
            outlier = warm and z > threshold
            counts[1] += 1
            if outlier:
                counts[0] += 1
            else:
                # Outliers are excluded from the baseline, or a burst of
                # them would normalize itself into "normal".
                win.append(value)
            return (round(z, 4) if z != float("inf") else z, outlier)

    def snapshot(self, route: str) -> dict:
        with self._lock:
            outliers, scored = self._counts.get(route, (0, 0))
            return {"outliers": outliers, "scored": scored,
                    "rate": round(outliers / scored, 4) if scored else 0.0}

    def totals(self) -> tuple[int, int]:
        with self._lock:
            return (sum(c[0] for c in self._counts.values()),
                    sum(c[1] for c in self._counts.values()))


class UpstreamHealth:
    """Per-backend health with circuit breaking (the envoy outlier-
    detection role ambassador delegates to envoy; this platform's front
    door implements it natively):

    - passive observation: every proxied request records success/failure
      (connect errors and 5xx); ``failure_threshold`` consecutive
      failures EJECT the backend from every route's pick set for
      ``ejection_seconds``;
    - half-open recovery: after the ejection window one trial request is
      let through — success closes the circuit, failure re-ejects with
      doubled backoff (capped 10×);
    - active probes: a prober thread TCP-connects each known backend
      every ``probe_interval`` seconds so an upstream that died between
      requests is ejected (and a recovered one readmitted) without
      client traffic paying for the discovery.
    """

    def __init__(self, *, failure_threshold: int = 3,
                 ejection_seconds: float = 10.0,
                 clock: Callable[[], float] = time.monotonic):
        self.failure_threshold = failure_threshold
        self.ejection_seconds = ejection_seconds
        self.clock = clock
        self._lock = threading.Lock()
        # service -> {fails, ejected_until, ejections, state-extras}
        self._state: dict[str, dict] = {}

    def _cell(self, service: str) -> dict:
        return self._state.setdefault(service, {
            "consecutive_failures": 0, "ejected_until": 0.0,
            "ejections": 0, "half_open_inflight": False,
            "trial_started": 0.0, "last_change": self.clock(),
            "warming": False,
        })

    def record_success(self, service: str) -> None:
        with self._lock:
            cell = self._cell(service)
            recovered = (cell["consecutive_failures"]
                         >= self.failure_threshold)
            cell.update(consecutive_failures=0, ejected_until=0.0,
                        half_open_inflight=False)
            if recovered:
                cell.update(ejections=0, last_change=self.clock())

    # A half-open trial that never reported back (e.g. the request rode
    # an upgrade tunnel, which doesn't record outcomes) expires so the
    # backend isn't stuck "trial in flight" forever.
    TRIAL_TIMEOUT = 30.0

    def record_failure(self, service: str) -> None:
        with self._lock:
            cell = self._cell(service)
            cell["consecutive_failures"] += 1
            cell["half_open_inflight"] = False
            if cell["consecutive_failures"] >= self.failure_threshold:
                # Re-eject with doubled backoff per consecutive ejection
                # (half-open trial failed), capped at 10x — exponent
                # clamped so a long-dead backend can't grow a bigint.
                backoff = self.ejection_seconds * min(
                    2 ** min(cell["ejections"], 4), 10
                )
                cell["ejected_until"] = self.clock() + backoff
                cell["ejections"] += 1
                cell["last_change"] = self.clock()

    def _eligible_locked(self, cell: dict | None) -> bool:
        if cell is None or cell["consecutive_failures"] \
                < self.failure_threshold:
            return True
        if self.clock() < cell["ejected_until"]:
            return False
        if cell["half_open_inflight"] and (
                self.clock() - cell["trial_started"] < self.TRIAL_TIMEOUT):
            return False
        return True  # window elapsed: a trial may begin

    def set_warming(self, service: str, warming: bool) -> None:
        """A newborn upstream answering ``/healthz`` with ``warming`` is
        alive-but-not-serving: route-excluded like an ejection but with
        NO failure-counter penalty — it exits the moment its dispatch
        set finishes compiling, with zero half-open walk to pay."""
        with self._lock:
            cell = self._cell(service)
            if cell.get("warming") != bool(warming):
                cell["warming"] = bool(warming)
                cell["last_change"] = self.clock()

    def admits(self, service: str) -> bool:
        """Side-effect-free eligibility: healthy (and not a warming
        newborn), or ejection window elapsed with no trial in flight."""
        with self._lock:
            cell = self._state.get(service)
            if cell is not None and cell.get("warming"):
                return False
            return self._eligible_locked(cell)

    def begin_trial(self, service: str) -> None:
        """Mark the half-open trial as in flight for the backend a
        request was ACTUALLY routed to (never during pick-set filtering —
        an unpicked backend must not have its one trial consumed)."""
        with self._lock:
            cell = self._state.get(service)
            if (cell is not None
                    and cell["consecutive_failures"]
                    >= self.failure_threshold
                    and self.clock() >= cell["ejected_until"]):
                cell["half_open_inflight"] = True
                cell["trial_started"] = self.clock()

    def filter_healthy(self, services: list[str]) -> list[str]:
        """The pick set: ejected and warming backends drop out; if
        EVERYTHING is excluded, fail open with the full set (a wrong
        502 beats blackholing when the health data itself is suspect —
        and an all-warming pool serving slowly beats serving nobody)."""
        healthy = [s for s in services if self.admits(s)]
        return healthy or list(services)

    def probe(self, services: list[str],
              resolve: Callable[[str], str]) -> None:
        """Active probe of every service: a TCP connect is the
        liveness signal (protocol-agnostic — 'something is
        listening'), then a best-effort ``GET /healthz`` on the same
        socket distinguishes a WARMING newborn (mid weight-install /
        dispatch-set compile) from a serving one. Anything that
        connects but doesn't speak the health protocol reads as
        serving — no worse than the TCP-only probe."""
        for service in services:
            addr = resolve(service)
            host, _, port_s = addr.partition(":")
            try:
                with socket.create_connection(
                        (host, int(port_s or 80)), timeout=2.0) as sock:
                    warming = self._probe_warming(sock, host)
                self.set_warming(service, warming)
                self.record_success(service)
            except OSError:
                self.record_failure(service)

    @staticmethod
    def _probe_warming(sock: socket.socket, host: str) -> bool:
        """Raw-socket health read on the already-connected probe
        socket. Returns True only on an explicit ``"warming"`` status;
        a non-HTTP listener, timeout, or parse failure is False —
        warming must only ever be asserted by the upstream itself."""
        try:
            sock.settimeout(2.0)
            sock.sendall((f"GET /healthz HTTP/1.1\r\nHost: {host}\r\n"
                          "Connection: close\r\n\r\n").encode())
            data = b""
            while len(data) < 65536:
                chunk = sock.recv(4096)
                if not chunk:
                    break
                data += chunk
                if b"}" in data:  # the one-line JSON body landed
                    break
            return b'"warming"' in data
        except OSError:
            return False

    def snapshot(self) -> dict:
        with self._lock:
            now = self.clock()
            return {
                svc: {
                    "healthy": cell["consecutive_failures"]
                    < self.failure_threshold,
                    "consecutive_failures": cell["consecutive_failures"],
                    "ejected_for_seconds": round(
                        max(0.0, cell["ejected_until"] - now), 2),
                    "ejections": cell["ejections"],
                    "warming": bool(cell.get("warming")),
                }
                for svc, cell in self._state.items()
            }


class BackendLoad:
    """Per-backend in-flight request counter — the gateway-local queue
    depth the ``prefix-affine`` route strategy spills on. Passive and
    exact for the traffic THIS gateway carries (the pressure signal must
    not depend on a metrics scrape being fresh): acquired when a request
    is dispatched upstream, released when its relay finishes, streamed
    bodies included."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._in_flight: dict[str, int] = {}

    def acquire(self, service: str) -> None:
        with self._lock:
            self._in_flight[service] = self._in_flight.get(service, 0) + 1

    def release(self, service: str) -> None:
        with self._lock:
            n = self._in_flight.get(service, 0) - 1
            if n > 0:
                self._in_flight[service] = n
            else:
                self._in_flight.pop(service, None)

    def depth(self, service: str) -> int:
        with self._lock:
            return self._in_flight.get(service, 0)

    def least_loaded(self, services: list[str]) -> str | None:
        """The lowest-depth service; ties keep the CALLER's order (the
        rendezvous spill sequence), so spill targets are deterministic."""
        with self._lock:
            if not services:
                return None
            return min(services,
                       key=lambda s: (self._in_flight.get(s, 0),
                                      services.index(s)))

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self._in_flight)


class KvFillCache:
    """Staleness-bounded KV-pool-fill signal per backend, scraped from
    the model server's exposition (``serving_kv_bytes_in_use`` /
    ``serving_kv_bytes_total``) — the gateway-side complement to the
    local in-flight depth the prefix-affine spill reads (the in-process
    ``DecoderFleet`` already honors ``kv_pressure``; this brings the
    HTTP path to parity).

    The request path only ever READS the cache: a fresh value serves
    directly; a stale one serves while kicking off at most one
    background refresh (the scrape's network latency never lands on a
    client request); a backend never scraped — or whose last scrape
    failed — yields None, which the spill policy treats as "signal
    unavailable", NEVER as "pool empty" (an unscrapeable replica must
    not look like the least-loaded spill target)."""

    def __init__(self, *, ttl: float = 5.0, fetch=None,
                 clock: Callable[[], float] = time.monotonic):
        self.ttl = float(ttl)
        self.clock = clock
        self.fetch = fetch or self._http_fetch
        self._lock = threading.Lock()
        # service -> {"fill": float | None, "at": t, "refreshing": bool}
        self._cells: dict[str, dict] = {}
        self.scrapes = 0
        self.scrape_failures = 0

    @staticmethod
    def _http_fetch(addr: str, timeout: float = 2.0) -> float | None:
        """One exposition GET reduced to in_use/total (None on any
        failure or an unpriced pool — no bytes gauge means no signal)."""
        import urllib.request

        try:
            with urllib.request.urlopen(
                    f"http://{addr}/monitoring/prometheus/metrics",
                    timeout=timeout) as resp:
                text = resp.read().decode("utf-8", "replace")
        except (OSError, ValueError):
            return None
        vals = {}
        for line in text.splitlines():
            parts = line.split()
            if len(parts) == 2 and parts[0] in ("serving_kv_bytes_in_use",
                                                "serving_kv_bytes_total"):
                try:
                    vals[parts[0]] = float(parts[1])
                except ValueError:
                    continue
        total = vals.get("serving_kv_bytes_total", 0.0)
        if total <= 0:
            return None
        return vals.get("serving_kv_bytes_in_use", 0.0) / total

    def _refresh(self, service: str, addr: str) -> None:
        fill = self.fetch(addr)
        with self._lock:
            cell = self._cells.setdefault(service, {})
            if fill is None:
                # Keep serving the stale value inside a grace window
                # (2x ttl); past it the signal goes dark rather than
                # spill on ancient data.
                self.scrape_failures += 1
                at = cell.get("at", 0.0)
                if self.clock() - at > 2 * self.ttl:
                    cell["fill"] = None
            else:
                cell.update(fill=fill, at=self.clock())
            cell["refreshing"] = False
            self.scrapes += 1

    def fill(self, service: str,
             resolve: Callable[[str], str] = lambda a: a) -> float | None:
        """Last-known fill fraction for ``service`` (None = no signal).
        Triggers ONE background refresh when the value is stale."""
        with self._lock:
            cell = self._cells.setdefault(
                service, {"fill": None, "at": 0.0, "refreshing": False})
            fresh = self.clock() - cell.get("at", 0.0) < self.ttl \
                and cell.get("fill") is not None
            if not fresh and not cell["refreshing"]:
                cell["refreshing"] = True
                # tpu-lint: disable=thread-no-join -- one-shot refresh; exits after a single scrape
                threading.Thread(
                    target=self._refresh,
                    args=(service, resolve(service)),
                    daemon=True).start()
            return cell.get("fill")

    def snapshot(self) -> dict:
        with self._lock:
            return {svc: cell.get("fill")
                    for svc, cell in self._cells.items()}


class BanditStats:
    """Per-(route, backend) reward averages for epsilon-greedy routes."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._stats: dict[tuple[str, str], list[float]] = {}

    def record(self, route: str, service: str, reward: float) -> None:
        with self._lock:
            cell = self._stats.setdefault((route, service), [0.0, 0])
            cell[0] += reward
            cell[1] += 1

    def pick(self, route: Route, rng, services: list[str] | None = None
             ) -> str:
        """Explore uniformly with prob epsilon; otherwise exploit the best
        mean reward. Untried backends are optimistic (mean 1.0), so every
        variant gets traffic before exploitation locks in. ``services``
        restricts the arms (the health layer's ejection filter)."""
        if services is None:
            services = [b[0] for b in route.backends]
        if rng.random() < route.epsilon:
            return rng.choice(services)
        with self._lock:
            def mean(svc: str) -> float:
                total, n = self._stats.get((route.name, svc), (0.0, 0))
                return total / n if n else 1.0

            best = max(mean(s) for s in services)
            top = [s for s in services if mean(s) == best]
        return rng.choice(top)

    def snapshot(self, route_name: str) -> dict:
        with self._lock:
            return {
                svc: {"reward_sum": round(total, 4), "trials": n,
                      "mean": round(total / n, 4) if n else None}
                for (rname, svc), (total, n) in self._stats.items()
                if rname == route_name
            }


