"""The job API's names and the scheduler's placement contract that the
training loop reads; copies of what it uses of ``kubeflow_tpu/apis/jobs.py``
and ``kubeflow_tpu/apis/scheduling.py`` (the port imports nothing of the
JAX package).

The JaxJob controller injects the owning job's identity into every worker
(:data:`ENV_JOB_NAME`, :data:`ENV_JOB_NAMESPACE`, :data:`ENV_JOB_KIND`):
the loop publishes its final metrics into that job's ``status.metrics``
and, when elastic, polls the job's placement annotation for its grant.
"""

from __future__ import annotations

import json
from typing import Mapping

API_GROUP = "kubeflow-tpu.org"
JOBS_API_VERSION = f"{API_GROUP}/v1"

ENV_JOB_NAME = "KUBEFLOW_TPU_JOB_NAME"
ENV_JOB_NAMESPACE = "KUBEFLOW_TPU_JOB_NAMESPACE"
ENV_JOB_KIND = "KUBEFLOW_TPU_JOB_KIND"

# Each job kind's REST plural (the job CRDs are namespaced), as
# apis/jobs.py's job_crd registers them.
JOB_PLURALS: dict[str, str] = {
    "JaxJob": "jaxjobs",
    "TFJob": "tfjobs",
    "PyTorchJob": "pytorchjobs",
    "MXNetJob": "mxnetjobs",
    "ChainerJob": "chainerjobs",
    "MPIJob": "mpijobs",
}
# Every job kind, in JAX's order (``kubeflow_tpu/apis/jobs.py``'s
# ``ALL_JOB_KINDS``): the dashboards list each.
ALL_JOB_KINDS = tuple(JOB_PLURALS)

# The scheduler's decision for a gang, one JSON annotation on the job:
# {"pool", "topology", "slice", "nodes", "decidedAt"} and, for an elastic
# job, "elastic": {"granted": n, "min": m, "max": M}.
ANN_PLACEMENT = f"{API_GROUP}/placement"


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
