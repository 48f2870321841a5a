"""The platform's front door for the port: counterparts of
``kubeflow_tpu/manifests/packages/common.py``'s ``gateway`` and
``centraldashboard`` prototypes.

Each renders JAX's objects on the port's image, running ``python -m
kubeflow_tpu_torch.gateway`` or ``python -m kubeflow_tpu_torch.dashboard``
(host code: neither needs a GPU, so neither requests one).
"""

from __future__ import annotations

from kubeflow_tpu_torch.manifests import images
from kubeflow_tpu_torch.manifests import objects as k8s
from kubeflow_tpu_torch.manifests.core import (
    DEFAULT_NAMESPACE,
    ParamSpec,
    gateway_route,
    prototype,
)


@prototype(
    "gateway",
    "API gateway: annotation-discovered reverse proxy fronting the "
    "platform's UIs/APIs and the port's InferenceService replicas",
    params=[
        ParamSpec("namespace", DEFAULT_NAMESPACE),
        ParamSpec("image", images.TORCH_CUDA),
        ParamSpec("replicas", 3, "gateway replicas"),
        ParamSpec("service_type", "ClusterIP",
                  "ClusterIP | NodePort | LoadBalancer"),
        ParamSpec("tls_secret", "",
                  "TLS Secret (tls.crt/tls.key) for HTTPS termination "
                  "(empty = HTTP)"),
    ],
)
def gateway(namespace: str, image: str, replicas: int, service_type: str,
            tls_secret: str) -> list[dict]:
    name = "gateway"
    labels = {"app": name, "service": "gateway"}
    tls_args, tls_mounts, tls_volumes = [], [], []
    if tls_secret:
        tls_args = ["--tls-cert=/etc/tls/tls.crt",
                    "--tls-key=/etc/tls/tls.key"]
        tls_mounts = [k8s.volume_mount("tls", "/etc/tls", read_only=True)]
        tls_volumes = [k8s.secret_volume("tls", tls_secret)]
    return [
        k8s.service_account(name, namespace, labels),
        k8s.cluster_role(
            name,
            [k8s.policy_rule([""], ["services"], ["get", "list", "watch"])],
            labels,
        ),
        k8s.cluster_role_binding(name, name, name, namespace),
        k8s.service(
            name, namespace, selector=labels,
            ports=[{"name": "http", "port": 80, "targetPort": 8080}],
            labels=labels, service_type=service_type,
        ),
        k8s.service(
            f"{name}-admin", namespace, selector=labels,
            ports=[{"name": "admin", "port": 8877, "targetPort": 8877}],
            labels=labels,
        ),
        k8s.deployment(
            name, namespace,
            containers=[
                k8s.container(
                    name, image,
                    command=["python", "-m", "kubeflow_tpu_torch.gateway"],
                    args=["--port=8080", "--admin-port=8877",
                          f"--namespace={namespace}"] + tls_args,
                    ports={"http": 8080, "admin": 8877},
                    liveness_probe=k8s.http_probe("/healthz", 8877,
                                                  initial_delay=30),
                    readiness_probe=k8s.http_probe("/healthz", 8877),
                    volume_mounts=tls_mounts or None,
                )
            ],
            replicas=replicas, labels=labels, service_account=name,
            volumes=tls_volumes or None,
        ),
    ]


@prototype(
    "centraldashboard",
    "Central dashboard web app over the port's gateway routes",
    params=[
        ParamSpec("namespace", DEFAULT_NAMESPACE),
        ParamSpec("image", images.TORCH_CUDA),
    ],
)
def centraldashboard(namespace: str, image: str) -> list[dict]:
    name = "centraldashboard"
    labels = {"app": name}
    return [
        k8s.service_account(name, namespace, labels),
        k8s.cluster_role(
            name,
            [
                k8s.policy_rule([""], ["pods", "events", "namespaces",
                                       "nodes"], ["get", "list", "watch"]),
                k8s.policy_rule(["kubeflow-tpu.org"], ["*"],
                                ["get", "list", "watch"]),
            ],
            labels,
        ),
        k8s.cluster_role_binding(name, name, name, namespace),
        k8s.service(
            name, namespace, selector=labels,
            ports=[{"name": "http", "port": 80, "targetPort": 8082}],
            labels=labels,
            annotations=gateway_route(name, "/", f"{name}.{namespace}:80"),
        ),
        k8s.deployment(
            name, namespace,
            containers=[
                k8s.container(
                    name, image,
                    command=["python", "-m", "kubeflow_tpu_torch.dashboard"],
                    ports={"http": 8082},
                    liveness_probe=k8s.http_probe("/healthz", 8082,
                                                  initial_delay=30),
                )
            ],
            labels=labels, service_account=name,
        ),
    ]
