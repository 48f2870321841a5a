"""Training-job CRD API types; a copy of what the job controllers use of
``kubeflow_tpu/apis/jobs.py`` (standard library only): the kinds and
their replica types, the CRDs, ``validate_job``, the environment names
and the conditions.

The schemas are JAX's: a job's ``spec.tpu.accelerator`` names the GPU
pool it is restricted to, and the pod templates carry ``nvidia.com/gpu``
(``manifests/images.gpu_resources``, the counterpart of JAX's
``tpu_resources``). The TPU rendezvous names (``TPU_*``) are not copied:
the port's job controller writes none of them and nothing of the port
reads them. The ``v1beta1`` conversion itself (``convert_job``) stays
with the platform's webhook; the CRD names it as JAX's does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Sequence

from kubeflow_tpu_torch.apis import API_GROUP
from kubeflow_tpu_torch.manifests import objects as k8s

DEFAULT_NAMESPACE = "kubeflow"

JOBS_API_VERSION = f"{API_GROUP}/v1"
# Deprecated-but-served version: replicaSpecs is a LIST of
# {replicaType, ...} entries. Storage stays at v1.
JOBS_API_V1BETA1 = f"{API_GROUP}/v1beta1"

JAX_JOB_KIND = "JaxJob"
TF_JOB_KIND = "TFJob"
PYTORCH_JOB_KIND = "PyTorchJob"
MXNET_JOB_KIND = "MXNetJob"
CHAINER_JOB_KIND = "ChainerJob"
MPI_JOB_KIND = "MPIJob"

REPLICA_TYPES: dict[str, tuple[str, ...]] = {
    JAX_JOB_KIND: ("Worker",),
    TF_JOB_KIND: ("Chief", "PS", "Worker", "Evaluator"),
    PYTORCH_JOB_KIND: ("Master", "Worker"),
    MXNET_JOB_KIND: ("Scheduler", "Server", "Worker"),
    CHAINER_JOB_KIND: ("Master", "Worker"),
    MPI_JOB_KIND: ("Launcher", "Worker"),
}

# Replica types limited to at most one replica.
SINGLETON_REPLICA_TYPES = {"Chief", "Master", "Scheduler", "Launcher"}

# Each job kind's REST plural (the job CRDs are namespaced).
PLURALS: dict[str, str] = {
    JAX_JOB_KIND: "jaxjobs",
    TF_JOB_KIND: "tfjobs",
    PYTORCH_JOB_KIND: "pytorchjobs",
    MXNET_JOB_KIND: "mxnetjobs",
    CHAINER_JOB_KIND: "chainerjobs",
    MPI_JOB_KIND: "mpijobs",
}

ALL_JOB_KINDS = tuple(PLURALS)

COND_CREATED = "Created"
COND_RUNNING = "Running"
COND_RESTARTING = "Restarting"
COND_SUCCEEDED = "Succeeded"
COND_FAILED = "Failed"

RESTART_POLICIES = ("Always", "OnFailure", "Never", "ExitCode")
CLEAN_POD_POLICIES = ("Running", "All", "None")

# The rendezvous env the controller writes into every JaxJob worker, which
# ``kubeflow_tpu_torch/parallel/distributed.py`` reads.
ENV_COORDINATOR_ADDRESS = "JAX_COORDINATOR_ADDRESS"
ENV_NUM_PROCESSES = "JAX_NUM_PROCESSES"
ENV_PROCESS_ID = "JAX_PROCESS_ID"
ENV_SLICE_ID = "MEGASCALE_SLICE_ID"
ENV_NUM_SLICES = "MEGASCALE_NUM_SLICES"
ENV_COORDINATOR_PORT = "JAX_COORDINATOR_PORT"

DEFAULT_COORDINATOR_PORT = 8476

# Identity of the owning job, injected into every worker: the training
# loop publishes its final metrics into that job's ``status.metrics`` and,
# when elastic, polls the job's placement annotation for its grant.
ENV_JOB_NAME = "KUBEFLOW_TPU_JOB_NAME"
ENV_JOB_NAMESPACE = "KUBEFLOW_TPU_JOB_NAMESPACE"
ENV_JOB_KIND = "KUBEFLOW_TPU_JOB_KIND"


@dataclass(frozen=True)
class Condition:
    type: str
    status: str  # "True" | "False" | "Unknown"
    reason: str = ""
    message: str = ""
    last_transition_time: str = ""

    def to_dict(self) -> dict:
        return {
            "type": self.type,
            "status": self.status,
            "reason": self.reason,
            "message": self.message,
            "lastTransitionTime": self.last_transition_time,
        }


# ---------------------------------------------------------------------------
# Validation schema shared by all job kinds
# ---------------------------------------------------------------------------


def _replica_spec_schema(replica_types: Sequence[str]) -> dict:
    props = {}
    for rt in replica_types:
        max_replicas = 1 if rt in SINGLETON_REPLICA_TYPES else None
        replicas: dict = {"type": "integer", "minimum": 0}
        if max_replicas is not None:
            replicas["maximum"] = max_replicas
        props[rt] = {
            "type": "object",
            "properties": {
                "replicas": replicas,
                "restartPolicy": {"type": "string",
                                  "enum": list(RESTART_POLICIES)},
                "template": {"type": "object",
                             "x-kubernetes-preserve-unknown-fields": True},
            },
        }
    return {"type": "object", "properties": props}


def _replica_list_schema(replica_types: Sequence[str]) -> dict:
    """The v1beta1 shape: replicaSpecs as a LIST of entries carrying
    ``replicaType``."""
    return {
        "type": "array",
        "items": {
            "type": "object",
            "required": ["replicaType"],
            "properties": {
                "replicaType": {"type": "string",
                                "enum": list(replica_types)},
                "replicas": {"type": "integer", "minimum": 0},
                "restartPolicy": {"type": "string",
                                  "enum": list(RESTART_POLICIES)},
                "template": {"type": "object",
                             "x-kubernetes-preserve-unknown-fields": True},
            },
        },
    }


def job_schema(kind: str, *, api_version: str | None = None) -> dict:
    list_shape = api_version == JOBS_API_V1BETA1
    return {
        "type": "object",
        "properties": {
            "spec": {
                "type": "object",
                "properties": {
                    "replicaSpecs": (
                        _replica_list_schema(REPLICA_TYPES[kind])
                        if list_shape
                        else _replica_spec_schema(REPLICA_TYPES[kind])),
                    # The pool block, JAX's name kept: accelerator names
                    # the GPU pool (cloud.google.com/gke-accelerator).
                    "tpu": {
                        "type": "object",
                        "properties": {
                            "accelerator": {"type": "string"},
                            "topology": {"type": "string"},
                            "numSlices": {"type": "integer", "minimum": 1},
                        },
                    },
                    "runPolicy": {
                        "type": "object",
                        "properties": {
                            "cleanPodPolicy": {
                                "type": "string",
                                "enum": list(CLEAN_POD_POLICIES),
                            },
                            "backoffLimit": {"type": "integer",
                                             "minimum": 0},
                            "activeDeadlineSeconds": {"type": "integer",
                                                      "minimum": 1},
                            "ttlSecondsAfterFinished": {"type": "integer",
                                                        "minimum": 0},
                        },
                    },
                    # Cluster-scheduler fields (apis/scheduling.py).
                    "priority": {"type": "integer"},
                    "queue": {"type": "string"},
                    "profile": {"type": "string"},
                    "preemptible": {"type": "boolean"},
                    # Elastic host range: the grant may move inside
                    # [minReplicas, maxReplicas] while the job runs.
                    "elastic": {
                        "type": "object",
                        "required": ["minReplicas", "maxReplicas"],
                        "properties": {
                            "minReplicas": {"type": "integer",
                                            "minimum": 1},
                            "maxReplicas": {"type": "integer",
                                            "minimum": 1},
                        },
                    },
                },
                "x-kubernetes-preserve-unknown-fields": True,
            },
            "status": {"type": "object",
                       "x-kubernetes-preserve-unknown-fields": True},
        },
    }


def job_crd(kind: str, *, conversion_namespace: str = DEFAULT_NAMESPACE,
            conversion_ca_bundle: str = "") -> dict:
    """The CRD of one job kind: ``v1`` served and stored, ``v1beta1``
    served and deprecated, converted by the platform's webhook."""
    def printer_columns() -> list[dict]:
        return [
            k8s.printer_column("State", ".status.state"),
            k8s.printer_column("Age", ".metadata.creationTimestamp",
                               "date"),
        ]

    v1beta1 = k8s.crd_version(
        "v1beta1",
        schema=job_schema(kind, api_version=JOBS_API_V1BETA1),
        served=True,
        storage=False,
        printer_columns=printer_columns(),
    )
    v1beta1["deprecated"] = True
    v1beta1["deprecationWarning"] = (
        f"{API_GROUP}/v1beta1 {kind} is deprecated; use {JOBS_API_VERSION}"
    )
    return k8s.crd(
        group=API_GROUP,
        kind=kind,
        plural=PLURALS[kind],
        short_names=[kind.lower().replace("job", "j")],
        categories=["all", "kubeflow-tpu"],
        versions=[
            k8s.crd_version(
                "v1",
                schema=job_schema(kind),
                served=True,
                storage=True,
                printer_columns=printer_columns(),
            ),
            v1beta1,
        ],
        conversion=k8s.crd_conversion_webhook(
            "admission-webhook", conversion_namespace,
            ca_bundle=conversion_ca_bundle),
    )


def all_job_crds(*, conversion_namespace: str = DEFAULT_NAMESPACE,
                 conversion_ca_bundle: str = "") -> list[dict]:
    return [job_crd(kind, conversion_namespace=conversion_namespace,
                    conversion_ca_bundle=conversion_ca_bundle)
            for kind in ALL_JOB_KINDS]


# ---------------------------------------------------------------------------
# Spec validation used by the controllers
# ---------------------------------------------------------------------------


class JobValidationError(ValueError):
    pass


def validate_job(job: Mapping) -> None:
    kind = job.get("kind", "")
    if kind not in REPLICA_TYPES:
        raise JobValidationError(f"unknown job kind {kind!r}")
    spec = job.get("spec", {})
    replica_specs = spec.get("replicaSpecs", {})
    if not replica_specs:
        raise JobValidationError(
            f"{kind} {job['metadata'].get('name')}: spec.replicaSpecs is empty"
        )
    allowed = REPLICA_TYPES[kind]
    for rt, rspec in replica_specs.items():
        if rt not in allowed:
            raise JobValidationError(
                f"{kind}: replica type {rt!r} not in {allowed}"
            )
        replicas = rspec.get("replicas", 1)
        if not isinstance(replicas, int) or replicas < 0:
            raise JobValidationError(
                f"{kind}/{rt}: invalid replicas {replicas!r}")
        if rt in SINGLETON_REPLICA_TYPES and replicas > 1:
            raise JobValidationError(
                f"{kind}/{rt}: at most 1 replica allowed")
        rp = rspec.get("restartPolicy")
        if rp is not None and rp not in RESTART_POLICIES:
            raise JobValidationError(
                f"{kind}/{rt}: invalid restartPolicy {rp!r}")
        tmpl = rspec.get("template", {})
        if not tmpl.get("spec", {}).get("containers"):
            raise JobValidationError(
                f"{kind}/{rt}: template has no containers")
    rp = spec.get("runPolicy", {})
    cpp = rp.get("cleanPodPolicy")
    if cpp is not None and cpp not in CLEAN_POD_POLICIES:
        raise JobValidationError(f"{kind}: invalid cleanPodPolicy {cpp!r}")
    priority = spec.get("priority")
    if priority is not None and not isinstance(priority, int):
        raise JobValidationError(f"{kind}: priority must be an integer")
    queue = spec.get("queue")
    if queue is not None and not isinstance(queue, str):
        raise JobValidationError(f"{kind}: queue must be a string")
    elastic = spec.get("elastic")
    if elastic is not None:
        if not isinstance(elastic, Mapping):
            raise JobValidationError(f"{kind}: elastic must be an object")
        try:
            lo = int(elastic["minReplicas"])
            hi = int(elastic["maxReplicas"])
        except (KeyError, TypeError, ValueError):
            raise JobValidationError(
                f"{kind}: elastic needs integer minReplicas/maxReplicas")
        if lo < 1 or hi < lo:
            raise JobValidationError(
                f"{kind}: elastic range [{lo}, {hi}] invalid "
                "(1 <= min <= max)")
        pods = sum(rs.get("replicas", 1) for rs in replica_specs.values())
        if lo < pods:
            # The grant never drops below the process count.
            raise JobValidationError(
                f"{kind}: elastic minReplicas {lo} below the gang's "
                f"{pods} pod(s); the host grant cannot drop under the "
                "process count")
