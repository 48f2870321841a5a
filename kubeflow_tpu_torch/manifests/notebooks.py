"""GPU notebooks: ``gpu-notebook-controller`` and ``gpu-jupyter-web-app``,
the counterparts of ``kubeflow_tpu/manifests/packages/notebooks.py``'s
``notebook-controller`` and ``jupyter-web-app``.

Equal to JAX's but for the image (the port's, with no GPU: both are host
processes) and the module (``kubeflow_tpu_torch.operators.notebook``,
``kubeflow_tpu_torch.webapps.jupyter``); the web app's default notebook
image is the port's notebook image (``images.NOTEBOOK``), and its
notebooks ask for ``nvidia.com/gpu``. Deploy these in place of JAX's on a
GPU cluster, never both.
"""

from __future__ import annotations

from kubeflow_tpu_torch.apis import API_GROUP
from kubeflow_tpu_torch.apis.notebooks import notebook_crd
from kubeflow_tpu_torch.manifests import images
from kubeflow_tpu_torch.manifests import objects as k8s
from kubeflow_tpu_torch.manifests.core import (
    DEFAULT_NAMESPACE,
    ParamSpec,
    gateway_route,
    prototype,
)


@prototype(
    "gpu-notebook-controller",
    "Notebook CRD + the port's controller: Notebook CRs as StatefulSet + "
    "Service on GPU nodes (notebook-controller's counterpart)",
    params=[
        ParamSpec("namespace", DEFAULT_NAMESPACE),
        ParamSpec("image", images.TORCH_CUDA),
    ],
)
def gpu_notebook_controller(namespace: str, image: str) -> list[dict]:
    name = "notebook-controller"
    labels = {"app": name}
    return [
        notebook_crd(),
        k8s.service_account(name, namespace, labels),
        k8s.cluster_role(
            name,
            [
                k8s.policy_rule([API_GROUP], ["notebooks",
                                              "notebooks/status"], ["*"]),
                k8s.policy_rule([""], ["services", "events"], ["*"]),
                k8s.policy_rule(["apps"], ["statefulsets"], ["*"]),
                k8s.policy_rule([""], ["pods"], ["get", "list", "watch"]),
            ],
            labels,
        ),
        k8s.cluster_role_binding(name, name, name, namespace),
        k8s.deployment(
            name,
            namespace,
            containers=[
                k8s.container(
                    name,
                    image,
                    command=["python", "-m",
                             "kubeflow_tpu_torch.operators.notebook"],
                    ports={"metrics": 8443},
                )
            ],
            labels=labels,
            service_account=name,
        ),
    ]


@prototype(
    "gpu-jupyter-web-app",
    "Notebook CRUD web UI over GPU notebooks: lists/creates/deletes "
    "Notebook CRs + PVCs (jupyter-web-app's counterpart)",
    params=[
        ParamSpec("namespace", DEFAULT_NAMESPACE),
        ParamSpec("image", images.TORCH_CUDA),
        ParamSpec("default_notebook_image", images.NOTEBOOK),
    ],
)
def gpu_jupyter_web_app(namespace: str, image: str,
                        default_notebook_image: str) -> list[dict]:
    name = "jupyter-web-app"
    labels = {"app": name}
    return [
        k8s.service_account(name, namespace, labels),
        k8s.cluster_role(
            name,
            [
                k8s.policy_rule([API_GROUP], ["notebooks"], ["*"]),
                k8s.policy_rule(
                    [""],
                    ["persistentvolumeclaims", "namespaces", "pods",
                     "pods/log", "events"],
                    ["get", "list", "watch", "create", "delete"],
                ),
                k8s.policy_rule(["storage.k8s.io"], ["storageclasses"],
                                ["get", "list"]),
            ],
            labels,
        ),
        k8s.cluster_role_binding(name, name, name, namespace),
        k8s.config_map(
            f"{name}-config",
            namespace,
            {"defaultNotebookImage": default_notebook_image},
            labels=labels,
        ),
        k8s.service(
            name,
            namespace,
            selector=labels,
            ports=[{"name": "http", "port": 80, "targetPort": 5000}],
            labels=labels,
            annotations=gateway_route(name, "/jupyter/",
                                      f"{name}.{namespace}:80"),
        ),
        k8s.deployment(
            name,
            namespace,
            containers=[
                k8s.container(
                    name,
                    image,
                    command=["python", "-m",
                             "kubeflow_tpu_torch.webapps.jupyter"],
                    args=[f"--default-image={default_notebook_image}"],
                    ports={"http": 5000},
                    liveness_probe=k8s.http_probe("/healthz", 5000,
                                                  initial_delay=30),
                )
            ],
            labels=labels,
            service_account=name,
        ),
    ]
