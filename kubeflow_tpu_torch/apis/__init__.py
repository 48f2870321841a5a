"""The port's API types: copies of ``kubeflow_tpu/apis`` (the port imports
nothing of the JAX package). ``jobs`` holds the job kinds, their CRDs and
the env names the job controller writes; ``scheduling`` the cluster
scheduler's placement contract; the rest one CR family each.

The names the training loop reads are re-exported here: the JaxJob
controller injects the owning job's identity into every worker
(:data:`ENV_JOB_NAME`, :data:`ENV_JOB_NAMESPACE`, :data:`ENV_JOB_KIND`);
the loop publishes its final metrics into that job's ``status.metrics``
and, when elastic, polls the job's placement annotation for its grant
(:func:`placement_grant`).
"""

from __future__ import annotations

API_GROUP = "kubeflow-tpu.org"

from kubeflow_tpu_torch.apis.jobs import (  # noqa: E402
    ALL_JOB_KINDS,
    ENV_JOB_KIND,
    ENV_JOB_NAME,
    ENV_JOB_NAMESPACE,
    JOBS_API_VERSION,
)
from kubeflow_tpu_torch.apis.jobs import PLURALS as JOB_PLURALS  # noqa: E402
from kubeflow_tpu_torch.apis.scheduling import (  # noqa: E402
    ANN_PLACEMENT,
    placement,
    placement_grant,
)

__all__ = [
    "ALL_JOB_KINDS",
    "ANN_PLACEMENT",
    "API_GROUP",
    "ENV_JOB_KIND",
    "ENV_JOB_NAME",
    "ENV_JOB_NAMESPACE",
    "JOBS_API_VERSION",
    "JOB_PLURALS",
    "placement",
    "placement_grant",
]
