"""The reconciler runtime the port's controllers (Experiment,
InferenceService, Rollout) use; a copy of the part of
``kubeflow_tpu/operators/base.py``'s ``Controller`` they call
(``reconcile_all``, ``_safe_reconcile``, ``reconcile_deleted``,
``_push_status`` with its retry on conflict, the failure backoff, the
operator metrics) and of ``kubeflow_tpu/runtime.py``'s ``HealthServer``,
kept in this package so the port imports nothing of the JAX one.

Level-triggered, as JAX's: ``reconcile(obj)`` reads current state from
the client and must be idempotent. JAX's event-driven runtime (watch
pumps, a workqueue) is not copied: the port's manager (``python -m
kubeflow_tpu_torch.operators``) polls ``reconcile_all``. A pass honours
what JAX's workqueue would do with each object: the next pass comes at
the soonest requeue-after a reconcile returned (the autoscaler's scrape
period), at a failed object's backoff (JAX's per-key exponential
backoff, 0.01 s doubling to 5 s, counted in
``operator_workqueue_retries_total``), or at ``resync_seconds``; and an
object gone since the last pass gets ``reconcile_deleted``, as a
DELETED watch event gives it in JAX.
"""

from __future__ import annotations

import logging
import random
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Iterable

from kubeflow_tpu_torch.k8s_client import ApiError, K8sClient, retry_on_conflict
from kubeflow_tpu_torch.observability.metrics import (
    MetricRegistry,
    render_prometheus,
)

log = logging.getLogger(__name__)

# Process-wide operator registry, served by the manager's HealthServer:
# every controller lands its reconcile latency and conflict signals here,
# labeled by kind (JAX's family names).
OPERATOR_METRICS = MetricRegistry()
_M_RECONCILE = OPERATOR_METRICS.histogram(
    "operator_reconcile_seconds",
    "Reconcile call latency per kind", labels=("kind",))
_M_RETRIES = OPERATOR_METRICS.counter(
    "operator_workqueue_retries_total",
    "Keys requeued under failure backoff", labels=("kind",))
_M_CONFLICTS = OPERATOR_METRICS.counter(
    "operator_reconcile_conflicts_total",
    "Reconciles lost to optimistic-concurrency conflicts (409)",
    labels=("kind",))


class Controller:
    """Base reconciler for one (apiVersion, kind)."""

    api_version: str = ""
    kind: str = ""
    resync_seconds: float = 30.0
    backoff_base_seconds: float = 0.01
    backoff_max_seconds: float = 5.0

    def __init__(self, client: K8sClient):
        self.client = client
        # Consecutive failures per object key, for the backoff.
        self._failures: dict[tuple[str, str], int] = {}
        # The objects of the last pass, for reconcile_deleted.
        self._seen: dict[tuple[str, str], dict] = {}
        # Seconds until the soonest requeue the last pass asked for.
        self.requeue_after: float | None = None

    @property
    def _kind_label(self) -> str:
        return self.kind or type(self).__name__

    def reconcile(self, obj: dict) -> float | None:
        """Reconcile one object. Return a positive number of seconds to be
        requeued after that delay, or None when done."""
        raise NotImplementedError

    def reconcile_deleted(self, obj: dict) -> None:
        """Called once the primary object is gone — override to release
        state kept for it. ``obj`` is the last observed state."""

    @staticmethod
    def _key(obj: dict) -> tuple[str, str]:
        meta = obj.get("metadata", {})
        return meta.get("namespace", "") or "", meta.get("name", "")

    def reconcile_all(self) -> int:
        """One pass over every primary object; sets ``requeue_after``."""
        n = 0
        delays = []
        seen = {}
        for obj in self.client.list(self.api_version, self.kind):
            seen[self._key(obj)] = obj
            delay = self._safe_reconcile(obj)
            if delay is not None:
                delays.append(delay)
            n += 1
        for key in set(self._seen) - set(seen):
            self._failures.pop(key, None)
            self.reconcile_deleted(self._seen[key])
        self._seen = seen
        self.requeue_after = min(delays) if delays else None
        return n

    def _backoff(self, key: tuple[str, str]) -> float:
        """JAX's RateLimiter: the delay doubles per consecutive failure
        from the base up to the cap, times a jitter in [0.5, 1.5)."""
        n = self._failures.get(key, 0)
        self._failures[key] = n + 1
        _M_RETRIES.labels(self._kind_label).inc()
        delay = min(self.backoff_base_seconds * (2 ** n),
                    self.backoff_max_seconds)
        return delay * (0.5 + random.random())

    def _safe_reconcile(self, obj: dict) -> float | None:
        """Reconcile one object; the seconds until it wants its next
        reconcile (its requeue-after, or its backoff after a failure),
        or None."""
        key = self._key(obj)
        t0 = time.perf_counter()
        try:
            result = self.reconcile(obj)
        except ApiError as e:
            if e.code == 409:
                # Optimistic-concurrency loss: retried under backoff.
                _M_CONFLICTS.labels(self._kind_label).inc()
                log.debug("%s/%s conflict, backing off", self.kind, key[1])
            else:
                log.warning("%s/%s reconcile failed (%s), backing off",
                            self.kind, key[1], e)
            return self._backoff(key)
        except Exception:
            log.exception("%s/%s reconcile failed, backing off",
                          self.kind, key[1])
            return self._backoff(key)
        finally:
            _M_RECONCILE.labels(self._kind_label).observe(
                time.perf_counter() - t0)
        self._failures.pop(key, None)
        if isinstance(result, (int, float)) and result > 0:
            return float(result)
        return None

    def _push_status(self, obj: dict) -> dict | None:
        """Write ``obj``'s status onto the live object, refetching and
        reapplying on conflict. No-op when the live status already
        matches."""
        meta = obj["metadata"]

        def _write(client: K8sClient) -> dict | None:
            current = client.get_or_none(
                obj["apiVersion"], obj["kind"], meta["name"],
                meta.get("namespace"),
            )
            if current is None:
                return None
            if current.get("status") == obj.get("status"):
                return current
            current["status"] = obj.get("status", {})
            return client.update_status(current)

        return retry_on_conflict(self.client, _write)


def run_polling(controllers: Iterable[Controller],
                stop: threading.Event) -> None:
    """Call each controller's ``reconcile_all`` until ``stop`` is set,
    each pass at the soonest of its ``resync_seconds`` and the requeue
    its last pass asked for; a failed pass (the apiserver away) is
    logged and retried at the next tick."""
    controllers = list(controllers)
    due = [0.0] * len(controllers)
    while not stop.is_set():
        now = time.monotonic()
        for i, c in enumerate(controllers):
            if now >= due[i]:
                wait = c.resync_seconds
                try:
                    c.reconcile_all()
                    if c.requeue_after is not None:
                        wait = min(wait, c.requeue_after)
                except Exception:
                    log.exception("%s: reconcile pass failed", c.kind)
                due[i] = now + wait
        stop.wait(max(min(due) - time.monotonic(), 0.05))


class HealthServer:
    """``/healthz`` and ``/metrics`` on one port: the ``registries``'
    families, then the ``metrics_fn`` dict (names ending ``_total``
    typed counter, the rest gauge)."""

    def __init__(self, port: int,
                 metrics_fn: Callable[[], dict] | None = None,
                 registries: Iterable[MetricRegistry] = ()):
        self.port = port
        self._metrics_fn = metrics_fn or (lambda: {})
        self._registries = list(registries)
        self._httpd: ThreadingHTTPServer | None = None

    def render_metrics(self) -> str:
        text = "".join(r.render() for r in self._registries)
        return text + render_prometheus(self._metrics_fn())

    def start(self) -> None:
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                if self.path in ("/healthz", "/readyz", "/livez"):
                    body, ctype = b'{"status":"ok"}', "application/json"
                elif self.path == "/metrics":
                    body = server.render_metrics().encode()
                    ctype = "text/plain"
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._httpd = ThreadingHTTPServer(("0.0.0.0", self.port), Handler)
        self.port = self._httpd.server_address[1]  # resolve port 0
        threading.Thread(target=self._httpd.serve_forever,
                         daemon=True).start()

    def stop(self) -> None:
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
