"""GPU job prototypes for the port; counterparts of the job prototypes of
``kubeflow_tpu/manifests/packages/training.py`` whose default entry point
the port has (``kubeflow_tpu_torch/workloads/``): ``jax-job-simple``
(``allreduce_smoke``), ``tf-job`` (``tf_cnn``), ``pytorch-job``
(``torch_xla_ddp``) and ``slice-healthcheck`` (``slice_health``).

They render the same CR kinds (JaxJob, TFJob, PyTorchJob), which JAX's
job operator reconciles without JAX: it writes the rendezvous environment
that ``kubeflow_tpu_torch/parallel/distributed.py`` reads into every
worker. The mapping from the JAX prototypes: ``chips_per_worker`` becomes
``gpus_per_worker`` (``nvidia.com/gpu`` limits and requests; one process
a pod, so the default is one GPU), the TPU slice parameters
(``accelerator``, ``topology``, ``num_slices``) and the ``spec.tpu``
block go (so the operator sets no TPU nodeSelector), the image is the
port's and the module ``kubeflow_tpu_torch.workloads.*``. A default
command of a worker without a GPU adds ``--device=cpu``.

``training-dashboard`` renders JAX's dashboard Service and Deployment on
the port's image, running ``python -m
kubeflow_tpu_torch.dashboard.training`` (no GPU).
"""

from __future__ import annotations

from kubeflow_tpu_torch.apis import JOBS_API_VERSION
from kubeflow_tpu_torch.manifests import images
from kubeflow_tpu_torch.manifests import objects as k8s
from kubeflow_tpu_torch.manifests.core import (
    DEFAULT_NAMESPACE,
    ParamSpec,
    gateway_route,
    prototype,
)

JAX_JOB_KIND = "JaxJob"
TF_JOB_KIND = "TFJob"
PYTORCH_JOB_KIND = "PyTorchJob"


def _module_command(module: str, gpus: int, *args: str) -> list[str]:
    return ["python", "-m", f"kubeflow_tpu_torch.workloads.{module}", *args,
            *([] if gpus else ["--device=cpu"])]


def _worker_template(image: str, command: list[str], gpus: int) -> dict:
    return {
        "spec": {
            "containers": [
                k8s.container("worker", image, command=command,
                              resources=images.gpu_resources(gpus))
            ],
            "restartPolicy": "Never",
        }
    }


def _job(kind: str, name: str, namespace: str, replica_specs: dict,
         clean_pod_policy: str = "Running") -> dict:
    return {
        "apiVersion": JOBS_API_VERSION,
        "kind": kind,
        "metadata": k8s.metadata(name, namespace),
        "spec": {
            "replicaSpecs": replica_specs,
            "runPolicy": {"cleanPodPolicy": clean_pod_policy},
        },
    }


_JOB_PARAMS = [
    ParamSpec("name"),
    ParamSpec("namespace", DEFAULT_NAMESPACE),
    ParamSpec("image", images.TORCH_CUDA),
    ParamSpec("num_workers", 2, "worker pods (one process each)"),
    ParamSpec("gpus_per_worker", 1, "nvidia.com/gpu per worker pod"),
]


@prototype(
    "gpu-job-simple",
    "A simple JaxJob running the port's allreduce smoke workload on GPUs "
    "(jax-job-simple's counterpart)",
    params=_JOB_PARAMS
    + [ParamSpec("command", None, "override container command (list)")],
)
def gpu_job_simple(name: str, namespace: str, image: str, num_workers: int,
                   gpus_per_worker: int, command) -> list[dict]:
    command = command or _module_command("allreduce_smoke", gpus_per_worker)
    return [
        _job(
            JAX_JOB_KIND,
            name,
            namespace,
            {
                "Worker": {
                    "replicas": num_workers,
                    "restartPolicy": "OnFailure",
                    "template": _worker_template(image, command,
                                                 gpus_per_worker),
                }
            },
        )
    ]


@prototype(
    "gpu-tf-job",
    "TFJob with Worker (and optional PS) replicas running the port's "
    "tf_cnn on GPUs (tf-job's counterpart)",
    params=_JOB_PARAMS + [ParamSpec("num_ps", 0), ParamSpec("command", None)],
)
def gpu_tf_job(name: str, namespace: str, image: str, num_workers: int,
               gpus_per_worker: int, num_ps: int, command) -> list[dict]:
    specs = {
        "Worker": {
            "replicas": num_workers,
            "restartPolicy": "OnFailure",
            "template": _worker_template(
                image, command or _module_command("tf_cnn", gpus_per_worker),
                gpus_per_worker),
        }
    }
    if num_ps:
        specs["PS"] = {
            "replicas": num_ps,
            "restartPolicy": "OnFailure",
            "template": _worker_template(
                image, command or _module_command("tf_cnn", 0), 0),
        }
    return [_job(TF_JOB_KIND, name, namespace, specs)]


@prototype(
    "gpu-pytorch-job",
    "PyTorchJob with Master/Worker replicas running the port's DDP "
    "workload on GPUs (pytorch-job's counterpart)",
    params=_JOB_PARAMS + [ParamSpec("command", None)],
)
def gpu_pytorch_job(name: str, namespace: str, image: str, num_workers: int,
                    gpus_per_worker: int, command) -> list[dict]:
    command = command or _module_command("torch_xla_ddp", gpus_per_worker)
    return [
        _job(
            PYTORCH_JOB_KIND,
            name,
            namespace,
            {
                "Master": {
                    "replicas": 1,
                    "restartPolicy": "OnFailure",
                    "template": _worker_template(image, command,
                                                 gpus_per_worker),
                },
                "Worker": {
                    "replicas": num_workers,
                    "restartPolicy": "OnFailure",
                    "template": _worker_template(image, command,
                                                 gpus_per_worker),
                },
            },
        )
    ]


@prototype(
    "gpu-healthcheck",
    "Pre-flight GPU health probe JaxJob: device counts + a timed "
    "all-reduce (slice-healthcheck's counterpart)",
    params=_JOB_PARAMS,
)
def gpu_healthcheck(name: str, namespace: str, image: str, num_workers: int,
                    gpus_per_worker: int) -> list[dict]:
    command = _module_command(
        "slice_health", gpus_per_worker,
        f"--expect-local-devices={gpus_per_worker or 1}")
    return [
        _job(
            JAX_JOB_KIND,
            name,
            namespace,
            {
                "Worker": {
                    "replicas": num_workers,
                    "restartPolicy": "OnFailure",
                    "template": _worker_template(image, command,
                                                 gpus_per_worker),
                },
            },
        )
    ]


@prototype(
    "training-dashboard",
    "Training-job dashboard Service + Deployment with gateway route",
    params=[
        ParamSpec("namespace", DEFAULT_NAMESPACE),
        ParamSpec("image", images.TORCH_CUDA),
    ],
)
def training_dashboard(namespace: str, image: str) -> list[dict]:
    name = "training-dashboard"
    labels = {"app": name}
    return [
        k8s.service(
            name, namespace, selector=labels,
            ports=[{"name": "http", "port": 80, "targetPort": 8085}],
            labels=labels,
            annotations=gateway_route(name, f"/{name}/",
                                      f"{name}.{namespace}:80"),
        ),
        k8s.deployment(
            name, namespace,
            containers=[
                k8s.container(
                    name, image,
                    command=["python", "-m",
                             "kubeflow_tpu_torch.dashboard.training"],
                    ports={"http": 8085},
                )
            ],
            labels=labels, service_account="training-operator",
        ),
    ]
