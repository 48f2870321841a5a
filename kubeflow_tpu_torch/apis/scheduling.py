"""Cluster-scheduler API types: the SchedulingPolicy CRD and the placement
contract; a copy of ``kubeflow_tpu/apis/scheduling.py`` (standard library
only) over GPU nodes.

The scheduler (:mod:`kubeflow_tpu_torch.scheduler`) owns placement for
every training-job kind. Its API surface is JAX's:

- a ``SchedulingPolicy`` CR carrying the cluster-wide knobs (scheduling
  period, starvation aging, preemption policy, queue weights, throughput
  profiles); one reconcile of it is one scheduling round;
- job ``spec.priority`` / ``spec.queue`` / ``spec.profile`` /
  ``spec.preemptible`` / ``spec.elastic`` fields that opt a job into
  scheduler-managed placement;
- annotations that carry decisions between the scheduler and the job
  controller: the gang's reservation lands as ONE ``placement``
  annotation on the job (all-or-nothing), and preemption marks victims
  with ``preempted-by`` on the job and its pods.

Placement annotation value (JSON)::

    {"pool": "nvidia-h100-80gb", "topology": "", "slice": "s0",
     "nodes": ["node-a", "node-b"], "decidedAt": "..."}

The mapping from JAX's: a node's pool is GKE's GPU label
``cloud.google.com/gke-accelerator`` (e.g. ``nvidia-h100-80gb``) where
JAX reads the TPU label ``cloud.google.com/gke-tpu-accelerator``. GPU
nodes carry no topology label, so a placement's ``topology`` is ``""``.
The slice label, the annotations, the states, the CRD and the knobs are
JAX's. ``nodes`` has one entry a gang pod; the job controller maps pod
*i* onto ``nodes[i]`` (``spec.nodeName``).
"""

from __future__ import annotations

import json
from typing import Mapping

from kubeflow_tpu_torch.apis import API_GROUP
from kubeflow_tpu_torch.manifests import objects as k8s

DEFAULT_NAMESPACE = "kubeflow"

SCHEDULING_API_VERSION = f"{API_GROUP}/v1"
SCHEDULING_POLICY_KIND = "SchedulingPolicy"
SCHEDULING_POLICY_PLURAL = "schedulingpolicies"

# Node labels the capacity model reads: GKE's GPU accelerator label names
# the pool; the slice label groups hosts into one slice a gang must land
# wholly inside (a node without one is a slice of its own).
NODE_ACCEL_LABEL = "cloud.google.com/gke-accelerator"
NODE_SLICE_LABEL = f"{API_GROUP}/slice"

# Decision-carrying annotations (job + pod metadata).
ANN_PLACEMENT = f"{API_GROUP}/placement"
ANN_PREEMPTED_BY = f"{API_GROUP}/preempted-by"
ANN_POOL = f"{API_GROUP}/pool"
ANN_SLICE = f"{API_GROUP}/slice"

# Scheduler-owned job condition types (the job controller's lifecycle
# conditions stay the job controller's).
COND_QUEUED = "Queued"
COND_UNSCHEDULABLE = "Unschedulable"

# status.scheduling.state values.
STATE_QUEUED = "Queued"
STATE_ADMITTED = "Admitted"
STATE_PREEMPTED = "Preempted"
STATE_UNSCHEDULABLE = "Unschedulable"

DEFAULT_SCHEDULING_PERIOD_SECONDS = 5.0
DEFAULT_AGING_SECONDS = 300.0
DEFAULT_REQUEUE_BACKOFF_SECONDS = 10.0
DEFAULT_QUEUE = "default"
DEFAULT_QUEUE_WEIGHT = 1.0


def is_managed(job: Mapping) -> bool:
    """A job is scheduler-managed iff it asks for queueing: an explicit
    priority or queue opts in. Unmanaged jobs keep the first-come path
    (a bare nodeSelector)."""
    spec = job.get("spec", {})
    return spec.get("priority") is not None or bool(spec.get("queue"))


def job_priority(job: Mapping) -> int:
    p = job.get("spec", {}).get("priority")
    return int(p) if p is not None else 0


def job_queue(job: Mapping) -> str:
    return job.get("spec", {}).get("queue") or DEFAULT_QUEUE


def is_preemptible(job: Mapping) -> bool:
    return bool(job.get("spec", {}).get("preemptible", True))


def elastic_spec(job: Mapping) -> dict | None:
    """The job's elastic range, ``{"min": minReplicas, "max":
    maxReplicas}`` in hosts, or None for a fixed-size gang. Malformed
    blocks read as non-elastic so the scheduler never resizes on
    garbage."""
    raw = job.get("spec", {}).get("elastic")
    if not isinstance(raw, Mapping):
        return None
    try:
        lo = int(raw.get("minReplicas", 1))
        hi = int(raw.get("maxReplicas", lo))
    except (TypeError, ValueError):
        return None
    if lo < 1 or hi < lo:
        return None
    return {"min": lo, "max": hi}


def placement(job: Mapping) -> dict | None:
    """The job's placement annotation parsed; None when unplaced (or the
    annotation is malformed, which reads as unplaced)."""
    raw = job.get("metadata", {}).get("annotations", {}).get(ANN_PLACEMENT)
    if not raw:
        return None
    try:
        decided = json.loads(raw)
    except (TypeError, ValueError):
        return None
    if not isinstance(decided, dict) or not decided.get("nodes"):
        return None
    return decided


def encode_placement(pool: str, topology: str, slice_id: str,
                     nodes: list[str], decided_at: str,
                     elastic: Mapping | None = None) -> str:
    """``elastic`` (elastic jobs only) carries ``{"granted": n, "min": m,
    "max": M}`` so the training loop maps its host grant onto a device
    count without a second read."""
    decided = {
        "pool": pool, "topology": topology, "slice": slice_id,
        "nodes": list(nodes), "decidedAt": decided_at,
    }
    if elastic is not None:
        decided["elastic"] = dict(elastic)
    return json.dumps(decided, sort_keys=True)


def placement_grant(job: Mapping) -> tuple[int, int] | None:
    """(granted, max) hosts of an elastic placement; None when the job is
    unplaced or not elastic. The ratio is the elastic loop's resize signal
    (train/elastic.py)."""
    decided = placement(job)
    if decided is None:
        return None
    elastic = decided.get("elastic")
    if not isinstance(elastic, Mapping):
        return None
    try:
        granted = int(elastic.get("granted", len(decided["nodes"])))
        cap = int(elastic["max"])
    except (KeyError, TypeError, ValueError):
        return None
    if granted < 1 or cap < granted:
        return None
    return granted, cap


# ---------------------------------------------------------------------------
# SchedulingPolicy CRD
# ---------------------------------------------------------------------------


def scheduling_policy_schema() -> dict:
    return {
        "type": "object",
        "properties": {
            "spec": {
                "type": "object",
                "properties": {
                    "schedulingPeriodSeconds": {
                        "type": "number", "minimum": 0.01},
                    "agingSeconds": {
                        # Seconds of queue wait worth one priority point
                        # (starvation aging); 0 disables aging.
                        "type": "number", "minimum": 0},
                    "preemption": {
                        "type": "object",
                        "properties": {
                            "enabled": {"type": "boolean"},
                            "minPriorityGap": {
                                # A preemptor must outrank its victim by
                                # strictly more than this many points.
                                "type": "integer", "minimum": 0},
                            "requeueBackoffSeconds": {
                                "type": "number", "minimum": 0},
                            "gracePeriodSeconds": {
                                "type": "number", "minimum": 0},
                        },
                    },
                    "elastic": {
                        # Live-resize policy for jobs declaring
                        # spec.elastic: shrink before preempting, grow
                        # into idle capacity after the queue pass.
                        "type": "object",
                        "properties": {
                            "shrinkBeforePreempt": {"type": "boolean"},
                            "growEnabled": {"type": "boolean"},
                            "growDelaySeconds": {
                                # Quiet period after a shrink before the
                                # same job may grow back (anti-thrash).
                                "type": "number", "minimum": 0},
                        },
                    },
                    "queues": {
                        "type": "array",
                        "items": {
                            "type": "object",
                            "required": ["name"],
                            "properties": {
                                "name": {"type": "string"},
                                "weight": {"type": "number",
                                           "exclusiveMinimum": 0},
                            },
                        },
                    },
                    "profiles": {
                        # profile -> accelerator -> measured throughput:
                        # the Gavel-style heterogeneity signal.
                        "type": "object",
                        "x-kubernetes-preserve-unknown-fields": True,
                    },
                },
            },
            "status": {"type": "object",
                       "x-kubernetes-preserve-unknown-fields": True},
        },
    }


def scheduling_policy_crd() -> dict:
    return k8s.crd(
        group=API_GROUP,
        kind=SCHEDULING_POLICY_KIND,
        plural=SCHEDULING_POLICY_PLURAL,
        short_names=["schedpol"],
        categories=["all", "kubeflow-tpu"],
        versions=[
            k8s.crd_version(
                "v1",
                schema=scheduling_policy_schema(),
                served=True,
                storage=True,
                printer_columns=[
                    k8s.printer_column("Queued", ".status.queueDepth"),
                    k8s.printer_column("Age", ".metadata.creationTimestamp",
                                       "date"),
                ],
            ),
        ],
    )


def scheduling_policy(name: str = "default",
                      namespace: str = DEFAULT_NAMESPACE,
                      **spec) -> dict:
    return {
        "apiVersion": SCHEDULING_API_VERSION,
        "kind": SCHEDULING_POLICY_KIND,
        "metadata": k8s.metadata(name, namespace),
        "spec": spec,
    }


def policy_knobs(policy: Mapping) -> dict:
    """Resolve a policy spec into a flat knob dict with defaults."""
    spec = policy.get("spec", {}) if policy else {}
    preemption = spec.get("preemption", {}) or {}
    elastic = spec.get("elastic", {}) or {}
    weights = {DEFAULT_QUEUE: DEFAULT_QUEUE_WEIGHT}
    for q in spec.get("queues", []) or []:
        if isinstance(q, Mapping) and q.get("name"):
            weights[q["name"]] = float(q.get("weight",
                                             DEFAULT_QUEUE_WEIGHT))
    return {
        "period": float(spec.get("schedulingPeriodSeconds",
                                 DEFAULT_SCHEDULING_PERIOD_SECONDS)),
        "aging_seconds": float(spec.get("agingSeconds",
                                        DEFAULT_AGING_SECONDS)),
        "preemption_enabled": bool(preemption.get("enabled", True)),
        "min_priority_gap": int(preemption.get("minPriorityGap", 0)),
        "requeue_backoff": float(preemption.get(
            "requeueBackoffSeconds", DEFAULT_REQUEUE_BACKOFF_SECONDS)),
        "grace_seconds": float(preemption.get("gracePeriodSeconds", 30.0)),
        "shrink_enabled": bool(elastic.get("shrinkBeforePreempt", True)),
        "grow_enabled": bool(elastic.get("growEnabled", True)),
        "grow_delay": float(elastic.get("growDelaySeconds", 0.0)),
        "queue_weights": weights,
        "profiles": dict(spec.get("profiles", {}) or {}),
    }
