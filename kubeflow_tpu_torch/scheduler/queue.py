"""Priority/fairness queue ordering for the cluster scheduler; a copy of
``kubeflow_tpu/scheduler/queue.py``.

Pure functions over queue entries so the policy is unit-testable without
an apiserver. Ordering implements three forces, strongest first:

1. **Weighted fair sharing** across queues: the queue with the lowest
   used-share/weight ratio goes first (Gavel's fairness round), so one
   tenant cannot monopolize the cluster just by submitting first.
2. **Effective priority** within a queue: ``spec.priority`` plus
   starvation aging — every ``aging_seconds`` of queue wait is worth one
   priority point, so a low-priority gang behind a stream of
   high-priority arrivals is *eventually* first in line.
3. FIFO (queuedAt) as the tie-break.
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass, field
from typing import Mapping


def parse_time(ts: str) -> datetime.datetime:
    return datetime.datetime.fromisoformat(ts.replace("Z", "+00:00"))


def aged_priority(priority: float, waited_seconds: float,
                  aging_seconds: float) -> float:
    """Effective priority after starvation aging: every
    ``aging_seconds`` of wait is worth one priority point, so a
    low-priority entry behind a stream of high-priority arrivals is
    eventually first in line. ``aging_seconds <= 0`` disables aging.

    Pure float math (no datetimes, no k8s imports), as JAX's, which its
    serving QoS queue shares.
    """
    if aging_seconds <= 0:
        return float(priority)
    return float(priority) + max(waited_seconds, 0.0) / aging_seconds


def fairness_ratio(used_share: float, weight: float) -> float:
    """Weighted-fair ordering key: the queue/tenant with the LOWEST
    used-share/weight ratio goes first (Gavel's fairness round), so
    service converges to the configured weights under backlog."""
    return float(used_share) / max(float(weight), 1e-9)


@dataclass
class QueueEntry:
    """One queued (unplaced) gang."""

    key: tuple[str, str, str]  # (kind, namespace, name)
    priority: int
    queue: str
    hosts: int                 # hosts needed to admit (elastic: the floor)
    queued_at: datetime.datetime
    eligible_at: datetime.datetime | None = None  # preemption backoff
    accelerator: str | None = None
    profile: str | None = None
    preemptible: bool = True
    # Elastic range {"min", "max"} in hosts (apis/scheduling.elastic_spec):
    # admission reserves `hosts` (the floor) and opportunistically extends
    # toward max in the same round; None = fixed-size gang.
    elastic: dict | None = None
    job: dict = field(default_factory=dict, repr=False)

    def effective_priority(self, now: datetime.datetime,
                           aging_seconds: float) -> float:
        waited = (now - self.queued_at).total_seconds()
        return aged_priority(self.priority, waited, aging_seconds)


def order_queue(entries: list[QueueEntry], now: datetime.datetime, *,
                aging_seconds: float,
                queue_weights: Mapping[str, float],
                used_share: Mapping[str, float]) -> list[QueueEntry]:
    """Admission order for one scheduling round.

    ``used_share`` is each queue's currently-running share (hosts, or any
    consistent unit); entries still inside a preemption backoff window are
    pushed behind everything eligible (but kept — a round with spare
    capacity may still reach them once eligible)."""

    def fairness(entry: QueueEntry) -> float:
        return fairness_ratio(used_share.get(entry.queue, 0.0),
                              queue_weights.get(entry.queue, 1.0))

    def sort_key(entry: QueueEntry):
        backoff = (entry.eligible_at is not None
                   and entry.eligible_at > now)
        return (
            backoff,                                       # eligible first
            fairness(entry),                               # fair share
            -entry.effective_priority(now, aging_seconds),  # priority
            entry.queued_at,                               # FIFO
            entry.key,                                     # determinism
        )

    return sorted(entries, key=sort_key)
