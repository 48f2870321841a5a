"""Lease-based leader election for replicated controller managers; a copy
of ``kubeflow_tpu/operators/leader.py`` over the port's client.

What ``replicas`` above 1 in ``gpu-training-operator`` and
``gpu-scheduler`` rests on: N manager pods run, one holds a
``coordination.k8s.io/v1`` Lease and reconciles; the rest stand by and
take over when renewal lapses. client-go's leaderelection semantics, as
in JAX: acquire if unheld or expired, renew every ``renew_seconds``
(5 s), a lease valid ``lease_seconds`` (15 s), a renew deadline of 2/3
of the lease, expiry judged from observed (holder, renewTime)
transitions in monotonic time. Standard library only: a manager pod
imports no torch.
"""

from __future__ import annotations

import datetime
import logging
import math
import threading
import time
import uuid

from kubeflow_tpu_torch.k8s_client import (
    ApiError,
    K8sClient,
    retry_on_conflict,
)

log = logging.getLogger(__name__)

LEASE_API_VERSION = "coordination.k8s.io/v1"


def _now() -> datetime.datetime:
    return datetime.datetime.now(datetime.timezone.utc)


class LeaderElector:
    def __init__(self, client: K8sClient, *, name: str,
                 namespace: str = "kubeflow",
                 identity: str | None = None,
                 lease_seconds: float = 15.0,
                 renew_seconds: float = 5.0,
                 renew_deadline_seconds: float | None = None):
        self.client = client
        self.name = name
        self.namespace = namespace
        self.identity = identity or f"{name}-{uuid.uuid4().hex[:8]}"
        self.lease_seconds = lease_seconds
        self.renew_seconds = renew_seconds
        # How long a leader rides out transient renewal failures before
        # abdicating (client-go's renewDeadline, default 2/3 of the lease:
        # 10 s for the 15 s default). STRICTLY less than lease_seconds, so
        # a leader cut off from the apiserver stops reconciling before any
        # standby can possibly seize the lease — no two-leader window.
        self.renew_deadline_seconds = (
            renew_deadline_seconds if renew_deadline_seconds is not None
            else lease_seconds * 2.0 / 3.0
        )
        self._stop = threading.Event()
        self._is_leader = threading.Event()
        # Expiry is judged from locally *observed* (holder, renewTime)
        # transitions in monotonic time, never by comparing the remote
        # renewTime against the local wall clock — inter-node clock skew
        # larger than lease_seconds must not let a standby seize a healthy
        # leader's lease (client-go leaderelection semantics).
        self._observed_record: tuple | None = None
        self._observed_at: float | None = None
        self._last_renew: float | None = None  # monotonic, successful renews

    # ------------------------------------------------------------------

    def _lease_body(self) -> dict:
        return {
            "apiVersion": LEASE_API_VERSION,
            "kind": "Lease",
            "metadata": {"name": self.name, "namespace": self.namespace},
            "spec": {
                "holderIdentity": self.identity,
                # Lease durations are integer seconds in the K8s API; round
                # up so a fractional lease_seconds never truncates to 0.
                "leaseDurationSeconds": math.ceil(self.lease_seconds),
                # metav1.MicroTime requires fractional seconds; isoformat()
                # drops them when microsecond == 0 (client-go uses
                # RFC3339Micro for exactly this reason).
                "renewTime": _now().strftime("%Y-%m-%dT%H:%M:%S.%fZ"),
            },
        }

    def try_acquire(self) -> bool:
        """One acquire-or-renew attempt. Returns current leadership."""
        try:
            lease = self.client.get_or_none(
                LEASE_API_VERSION, "Lease", self.name, self.namespace
            )
            if lease is None:
                self.client.create(self._lease_body())
                log.info("%s: acquired new lease as %s", self.name,
                         self.identity)
                self._last_renew = time.monotonic()
                self._is_leader.set()
                return True
            spec = lease.get("spec", {})
            holder = spec.get("holderIdentity")
            renew = spec.get("renewTime")
            if not holder:
                # Voluntary release (release() clears holderIdentity) —
                # the lease is explicitly up for grabs.
                expired = True
            else:
                record = (holder, renew)
                if record != self._observed_record:
                    self._observed_record = record
                    self._observed_at = time.monotonic()
                if not renew:
                    expired = True
                else:
                    age = time.monotonic() - self._observed_at
                    expired = age > spec.get("leaseDurationSeconds",
                                             self.lease_seconds)
            if holder == self.identity or expired:
                lease["spec"] = self._lease_body()["spec"]
                self.client.update(lease)  # CAS via resourceVersion
                if not self._is_leader.is_set():
                    log.info("%s: %s lease as %s", self.name,
                             "took over expired" if holder != self.identity
                             else "renewed", self.identity)
                self._last_renew = time.monotonic()
                self._is_leader.set()
                return True
            self._is_leader.clear()
            return False
        except ApiError as e:
            if e.code == 409 and not self._is_leader.is_set():
                # Lost an acquire race to another candidate — definitive.
                return False
            log.warning("%s: lease attempt failed: %s", self.name, e)
            # A transient failure (apiserver 5xx, or a spurious conflict a
            # flaky proxy injected on our own renewal — the next attempt
            # refetches the lease and retries with a fresh resourceVersion)
            # must not demote a leader whose lease is still valid. But only
            # until the renew DEADLINE: abdicating strictly before the
            # lease expires guarantees a cut-off leader stops reconciling
            # before any standby can seize the lease (client-go
            # renewDeadline semantics — no two-leader window).
            if self._is_leader.is_set() and self._last_renew is not None:
                age = time.monotonic() - self._last_renew
                if age <= self.renew_deadline_seconds:
                    return True
            self._is_leader.clear()
            return False

    @property
    def is_leader(self) -> bool:
        return self._is_leader.is_set()

    def wait_for_leadership(self, timeout: float | None = None) -> bool:
        """Block (acquiring in a loop) until this candidate leads.
        ``timeout=0`` makes a single non-blocking attempt."""
        end = time.monotonic() + timeout if timeout is not None else None
        while not self._stop.is_set():
            if self.try_acquire():
                return True
            if end and time.monotonic() > end:
                return False
            self._stop.wait(self.renew_seconds)
        return False

    def run(self) -> None:
        """Acquire-then-renew loop (daemon thread); leadership state is
        exposed via :attr:`is_leader`."""
        while not self._stop.is_set():
            self.try_acquire()
            self._stop.wait(self.renew_seconds)

    def start(self) -> threading.Thread:
        self._thread = threading.Thread(
            target=self.run, name=f"lease-{self.name}", daemon=True
        )
        self._thread.start()
        return self._thread

    def release(self) -> None:
        """Drop the lease on clean shutdown so a standby takes over fast.
        Release is *explicit* — holderIdentity is cleared (client-go
        ReleaseOnCancel semantics), never inferred from timestamp
        regression, which an NTP step on the leader could mimic. Stops and
        joins the renew thread FIRST: an in-flight renewal after the clear
        would make the lease look freshly held by a dead process, and a
        renewal just before it would 409 the clear."""
        self._stop.set()
        thread = getattr(self, "_thread", None)
        if thread is not None:
            thread.join(timeout=2 * self.renew_seconds)
        if not self._is_leader.is_set():
            return

        def _clear(client: K8sClient) -> None:
            lease = client.get_or_none(
                LEASE_API_VERSION, "Lease", self.name, self.namespace
            )
            if not lease or lease.get("spec", {}).get(
                "holderIdentity"
            ) != self.identity:
                return
            lease["spec"]["holderIdentity"] = ""
            client.update(lease)

        try:
            retry_on_conflict(self.client, _clear, attempts=3)
        except ApiError:
            pass  # best effort — the lease will expire on its own
        self._is_leader.clear()
