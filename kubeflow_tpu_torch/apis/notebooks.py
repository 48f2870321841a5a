"""The Notebook CRD and CR builder; a copy of
``kubeflow_tpu/apis/notebooks.py`` for GPU notebooks.

The CRD is JAX's, schema and all: the ``spec.tpu`` block stays, and on
the port's GPU clusters it counts GPUs (as the port's job CRDs keep
JAX's ``spec.tpu``, ``apis/jobs.py``). :func:`notebook`, what the
jupyter web app POSTs, turns ``tpu_chips`` into ``nvidia.com/gpu``
limits; the notebook controller (``operators/notebooks.py``) does the
same for a CR whose ``spec.tpu.chips`` is set, and adds the GPU node
selector. Standard library only.
"""

from __future__ import annotations

from kubeflow_tpu_torch.apis import API_GROUP
from kubeflow_tpu_torch.manifests import objects as k8s
from kubeflow_tpu_torch.manifests.images import GPU_RESOURCE

NOTEBOOK_KIND = "Notebook"
NOTEBOOK_PLURAL = "notebooks"
NOTEBOOKS_API_VERSION = f"{API_GROUP}/v1"
NOTEBOOK_PORT = 8888


def notebook_crd() -> dict:
    schema = {
        "type": "object",
        "properties": {
            "spec": {
                "type": "object",
                "properties": {
                    "template": {
                        "type": "object",
                        "x-kubernetes-preserve-unknown-fields": True,
                    },
                    "tpu": {
                        "type": "object",
                        "properties": {
                            "accelerator": {"type": "string"},
                            "chips": {"type": "integer", "minimum": 0},
                        },
                    },
                },
                "x-kubernetes-preserve-unknown-fields": True,
            },
            "status": {"type": "object",
                       "x-kubernetes-preserve-unknown-fields": True},
        },
    }
    return k8s.crd(
        group=API_GROUP,
        kind=NOTEBOOK_KIND,
        plural=NOTEBOOK_PLURAL,
        short_names=["nb"],
        categories=["all", "kubeflow-tpu"],
        versions=[
            k8s.crd_version(
                "v1",
                schema=schema,
                storage=True,
                printer_columns=[
                    k8s.printer_column("State", ".status.state"),
                    k8s.printer_column("Age", ".metadata.creationTimestamp",
                                       "date"),
                ],
            )
        ],
    )


def notebook(
    name: str,
    namespace: str,
    image: str,
    tpu_chips: int = 0,
    cpu: str = "1",
    memory: str = "2Gi",
    workspace_pvc: str | None = None,
) -> dict:
    """A Notebook CR; ``tpu_chips`` GPUs (the CR's field keeps JAX's
    name) become ``nvidia.com/gpu`` limits on its container."""
    resources: dict = {"requests": {"cpu": cpu, "memory": memory}}
    if tpu_chips:
        resources["limits"] = {GPU_RESOURCE: tpu_chips}
    volumes = []
    mounts = []
    if workspace_pvc:
        volumes.append(k8s.pvc_volume("workspace", workspace_pvc))
        mounts.append(k8s.volume_mount("workspace", "/home/jovyan"))
    return {
        "apiVersion": NOTEBOOKS_API_VERSION,
        "kind": NOTEBOOK_KIND,
        "metadata": k8s.metadata(name, namespace, {"app": name}),
        "spec": {
            "template": {
                "spec": k8s.pod_spec(
                    [
                        k8s.container(
                            "notebook",
                            image,
                            resources=resources,
                            ports={"notebook": NOTEBOOK_PORT},
                            volume_mounts=mounts or None,
                            env={"JUPYTER_ENABLE_LAB": "true"},
                        )
                    ],
                    volumes=volumes or None,
                )
            },
            "tpu": {"chips": tpu_chips},
        },
    }
