"""The training operator and the GPU job prototypes for the port;
counterparts of ``kubeflow_tpu/manifests/packages/training.py``'s
``training-operator`` and of its job prototypes: ``jax-job-simple``
(``allreduce_smoke``), ``tf-job`` (``tf_cnn``), ``pytorch-job``
(``torch_xla_ddp``), ``mpi-job`` (``allreduce_bench`` under
``mpi_launcher``), ``mxnet-job`` and ``chainer-job`` (``allreduce_smoke``
by default; ``mxnet_ps`` and ``chainermn_train`` speak their rendezvous)
and ``slice-healthcheck`` (``slice_health``).

``gpu-training-operator`` renders JAX's job CRDs, config, RBAC and a
Deployment of the port's manager (``python -m
kubeflow_tpu_torch.operators``, with ``--leader-elect`` when
``replicas`` > 1) on the port's image, with no GPU (so
``--device=cpu``). The jobs render the same CR kinds, which the port's
job controllers reconcile: they write the rendezvous environment that
``kubeflow_tpu_torch/parallel/distributed.py`` and the compat workloads
read into every pod. The mapping from the JAX prototypes: ``chips_per_worker`` becomes
``gpus_per_worker`` (``nvidia.com/gpu`` limits and requests; one process
a pod, so the default is one GPU), the TPU slice parameters
(``accelerator``, ``topology``, ``num_slices``) and the ``spec.tpu``
block go (so the operator sets no TPU nodeSelector), the image is the
port's and the module ``kubeflow_tpu_torch.workloads.*``. A default
command of a replica without a GPU adds ``--device=cpu``. The MPI
Launcher asks for a worker's GPUs (JAX's asks for no chip): without
``mpirun`` it runs the workers' command itself.

``training-dashboard`` renders JAX's dashboard Service and Deployment on
the port's image, running ``python -m
kubeflow_tpu_torch.dashboard.training`` (no GPU).
"""

from __future__ import annotations

from kubeflow_tpu_torch.apis import API_GROUP, JOBS_API_VERSION
from kubeflow_tpu_torch.apis import jobs as jobs_api
from kubeflow_tpu_torch.apis import rl as rl_api
from kubeflow_tpu_torch.manifests import images
from kubeflow_tpu_torch.manifests import objects as k8s
from kubeflow_tpu_torch.manifests.core import (
    DEFAULT_NAMESPACE,
    ParamSpec,
    dump_yaml,
    gateway_route,
    prototype,
)

JAX_JOB_KIND = "JaxJob"
TF_JOB_KIND = "TFJob"
PYTORCH_JOB_KIND = "PyTorchJob"
MPI_JOB_KIND = "MPIJob"
MXNET_JOB_KIND = "MXNetJob"
CHAINER_JOB_KIND = "ChainerJob"


@prototype(
    "gpu-training-operator",
    "Job CRDs (JaxJob/TFJob/PyTorchJob/MXNetJob/ChainerJob/MPIJob) + the "
    "port's manager Deployment, RBAC and config (training-operator's "
    "counterpart)",
    params=[
        ParamSpec("namespace", DEFAULT_NAMESPACE),
        ParamSpec("image", images.TORCH_CUDA),
        ParamSpec("replicas", 1, "operator replicas (leader-elected)"),
        ParamSpec("default_workload_image", images.TORCH_CUDA),
        ParamSpec("cluster_scoped", True, "watch all namespaces (RBAC scope)"),
        ParamSpec("conversion_ca_bundle", "",
                  "base64 CA for the conversion webhook's serving cert "
                  "(the platform's webhook serves /convert for the "
                  "v1beta1 job API)"),
    ],
)
def gpu_training_operator(
    namespace: str,
    image: str,
    replicas: int,
    default_workload_image: str,
    cluster_scoped: bool,
    conversion_ca_bundle: str,
) -> list[dict]:
    name = "training-operator"
    labels = {"app": name, "app.kubernetes.io/part-of": "kubeflow-tpu"}
    objs: list[dict] = list(jobs_api.all_job_crds(
        conversion_namespace=namespace,
        conversion_ca_bundle=conversion_ca_bundle))
    objs.append(k8s.config_map(
        f"{name}-config", namespace,
        {"config.yaml": dump_yaml(
            {"defaultWorkloadImage": default_workload_image})},
        labels=labels))
    objs.append(k8s.service_account(name, namespace, labels))
    # The manager also runs the RLJob controller, which writes learner
    # and actor JaxJobs, so it needs the rljobs surface too.
    rules = [
        k8s.policy_rule(
            [API_GROUP],
            list(jobs_api.PLURALS.values())
            + [f"{p}/status" for p in jobs_api.PLURALS.values()]
            + [rl_api.RL_PLURAL, f"{rl_api.RL_PLURAL}/status"],
            ["*"],
        ),
        k8s.policy_rule([""], ["pods", "services", "events", "configmaps"],
                        ["*"]),
        k8s.policy_rule(["apps"], ["deployments", "statefulsets"],
                        ["get", "list", "watch"]),
        # Leader election holds a Lease when running replicated.
        k8s.policy_rule(["coordination.k8s.io"], ["leases"],
                        ["get", "list", "watch", "create", "update"]),
    ]
    if cluster_scoped:
        objs.append(k8s.cluster_role(name, rules, labels))
        objs.append(k8s.cluster_role_binding(name, name, name, namespace))
    else:
        objs.append(k8s.role(name, namespace, rules))
        objs.append(k8s.role_binding(
            name, namespace, name,
            [{"kind": "ServiceAccount", "name": name,
              "namespace": namespace}]))
    objs.append(k8s.deployment(
        name,
        namespace,
        containers=[
            k8s.container(
                name,
                image,
                command=["python", "-m", "kubeflow_tpu_torch.operators"],
                args=["--alsologtostderr", "-v=1"]
                + (["--leader-elect", "--leader-elect-name", name]
                   if replicas > 1 else [])
                # No GPU in the manager's pod: in-process trials run on
                # its CPU.
                + ["--device=cpu"],
                env={"OPERATOR_CONFIG": "/etc/config/config.yaml"},
                ports={"metrics": 8443},
                volume_mounts=[k8s.volume_mount("config", "/etc/config",
                                                read_only=True)],
            )
        ],
        replicas=replicas,
        labels=labels,
        service_account=name,
        volumes=[k8s.config_map_volume("config", f"{name}-config")],
        # The operator families (reconcile latency, retries, conflicts,
        # labelled by kind) on :8443.
        pod_annotations={
            "prometheus.io/scrape": "true",
            "prometheus.io/path": "/metrics",
            "prometheus.io/port": "8443",
        },
    ))
    return objs


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
    "gpu-mpi-job",
    "MPIJob: a Launcher running the command under mpi_launcher (mpirun, "
    "or the command itself) and GPU Workers (mpi-job's counterpart)",
    params=_JOB_PARAMS + [ParamSpec("command", None)],
)
def gpu_mpi_job(name: str, namespace: str, image: str, num_workers: int,
                gpus_per_worker: int, command) -> list[dict]:
    # The Launcher asks for no GPU, as JAX's asks for no chip: it writes
    # the controller's hostfile, waits for the workers' DNS, then runs
    # mpirun (the command on the workers) or, with no mpirun (the port's
    # image has none), the command itself here, where the default
    # command runs on the CPU.
    on_cpu = [] if command or not gpus_per_worker else [
        "--single-process-arg=--device=cpu"]
    command = command or _module_command("allreduce_bench", gpus_per_worker)
    launcher_command = [
        "python", "-m", "kubeflow_tpu_torch.workloads.mpi_launcher",
        *on_cpu, "--", *command,
    ]
    return [
        _job(
            MPI_JOB_KIND,
            name,
            namespace,
            {
                "Launcher": {
                    "replicas": 1,
                    "restartPolicy": "OnFailure",
                    "template": _worker_template(image, launcher_command,
                                                 0),
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
    "gpu-mxnet-job",
    "MXNetJob: Scheduler/Server (no GPU) and GPU Worker replicas "
    "(mxnet-job's counterpart)",
    params=_JOB_PARAMS + [ParamSpec("num_schedulers", 1),
                          ParamSpec("num_servers", 1),
                          ParamSpec("command", None)],
)
def gpu_mxnet_job(name: str, namespace: str, image: str, num_workers: int,
                  gpus_per_worker: int, num_schedulers: int,
                  num_servers: int, command) -> list[dict]:
    def cmd(gpus: int) -> list[str]:
        return command or _module_command("allreduce_smoke", gpus)

    return [
        _job(
            MXNET_JOB_KIND,
            name,
            namespace,
            {
                "Scheduler": {
                    "replicas": num_schedulers,
                    "restartPolicy": "Never",
                    "template": _worker_template(image, cmd(0), 0),
                },
                "Server": {
                    "replicas": num_servers,
                    "restartPolicy": "Never",
                    "template": _worker_template(image, cmd(0), 0),
                },
                "Worker": {
                    "replicas": num_workers,
                    "restartPolicy": "Never",
                    "template": _worker_template(
                        image, cmd(gpus_per_worker), gpus_per_worker),
                },
            },
        )
    ]


@prototype(
    "gpu-chainer-job",
    "ChainerJob: Master/Worker replicas on GPUs (chainer-job's "
    "counterpart)",
    params=_JOB_PARAMS + [ParamSpec("command", None)],
)
def gpu_chainer_job(name: str, namespace: str, image: str, num_workers: int,
                    gpus_per_worker: int, command) -> list[dict]:
    command = command or _module_command("allreduce_smoke", gpus_per_worker)
    return [
        _job(
            CHAINER_JOB_KIND,
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
