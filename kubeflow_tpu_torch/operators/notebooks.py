"""Notebook controller for GPU notebooks; a copy of
``kubeflow_tpu/operators/notebooks.py`` with the GPU mapping.

A Notebook CR becomes a one-replica StatefulSet and a Service, its
status mirrored from the pod's container state, as in JAX. The CR's
``spec.tpu`` block (JAX's CRD, kept) counts GPUs here: ``spec.tpu.chips``
becomes ``nvidia.com/gpu`` limits on the first container and
``spec.tpu.accelerator`` the ``cloud.google.com/gke-accelerator`` node
selector (e.g. ``nvidia-h100-80gb``), where JAX writes
``google.com/tpu`` and the TPU selector. An empty template gets the
port's notebook image (``images.NOTEBOOK``: the port's image with
JupyterLab). The StatefulSet, the Service, ``spec.suspend`` and the
status are JAX's. Standard library only.
"""

from __future__ import annotations

import copy

from kubeflow_tpu_torch.apis.notebooks import (
    NOTEBOOK_KIND,
    NOTEBOOK_PORT,
    NOTEBOOKS_API_VERSION,
)
from kubeflow_tpu_torch.manifests import objects as k8s
from kubeflow_tpu_torch.manifests.images import GPU_RESOURCE
from kubeflow_tpu_torch.manifests.images import (
    NOTEBOOK as DEFAULT_NOTEBOOK_IMAGE,
)
from kubeflow_tpu_torch.operators.base import Controller
from kubeflow_tpu_torch.operators.jobs import GKE_GPU_ACCEL_SELECTOR

LABEL_NOTEBOOK = "kubeflow-tpu.org/notebook-name"


class NotebookController(Controller):
    api_version = NOTEBOOKS_API_VERSION
    kind = NOTEBOOK_KIND

    def reconcile(self, nb: dict) -> None:
        nb = copy.deepcopy(nb)
        name = nb["metadata"]["name"]
        ns = nb["metadata"]["namespace"]

        sts = self._desired_statefulset(nb)
        existing = self.client.get_or_none("apps/v1", "StatefulSet", name, ns)
        if existing is None:
            self.client.create(sts)
        elif (
            existing.get("spec", {}).get("template") != sts["spec"]["template"]
            or existing.get("spec", {}).get("replicas")
            != sts["spec"]["replicas"]
        ):
            existing["spec"] = sts["spec"]
            self.client.update(existing)

        if self.client.get_or_none("v1", "Service", name, ns) is None:
            svc = k8s.service(
                name=name, namespace=ns,
                selector={LABEL_NOTEBOOK: name},
                ports=[{"name": "notebook", "port": NOTEBOOK_PORT,
                        "targetPort": NOTEBOOK_PORT}],
                labels={LABEL_NOTEBOOK: name},
            )
            svc["metadata"]["ownerReferences"] = [k8s.object_ref(nb)]
            self.client.create(svc)

        self._update_status(nb)

    def _desired_statefulset(self, nb: dict) -> dict:
        """The CR's pod template in a one-replica StatefulSet: a default
        Jupyter container when the template is empty, and the ``tpu``
        block expanded into GPU limits and the GPU node selector."""
        name = nb["metadata"]["name"]
        ns = nb["metadata"]["namespace"]
        spec = nb.get("spec", {})
        template = copy.deepcopy(spec.get("template", {})) or {}
        pod_spec = template.setdefault("spec", {})
        if not pod_spec.get("containers"):
            pod_spec["containers"] = [
                k8s.container(
                    "notebook",
                    DEFAULT_NOTEBOOK_IMAGE,
                    args=[
                        "jupyter", "lab", "--ip=0.0.0.0",
                        f"--port={NOTEBOOK_PORT}", "--no-browser",
                        "--allow-root",
                        f"--NotebookApp.base_url=/notebook/{ns}/{name}",
                    ],
                    ports={"notebook": NOTEBOOK_PORT},
                )
            ]
        gpu = spec.get("tpu", {})
        if gpu.get("chips"):
            main = pod_spec["containers"][0]
            resources = main.setdefault("resources", {})
            resources.setdefault("limits", {})[GPU_RESOURCE] = gpu["chips"]
            if gpu.get("accelerator"):
                pod_spec.setdefault("nodeSelector", {})[
                    GKE_GPU_ACCEL_SELECTOR
                ] = gpu["accelerator"]
        tmeta = template.setdefault("metadata", {})
        tmeta.setdefault("labels", {})[LABEL_NOTEBOOK] = name

        sts = {
            "apiVersion": "apps/v1",
            "kind": "StatefulSet",
            "metadata": k8s.metadata(name, ns, {LABEL_NOTEBOOK: name}),
            "spec": {
                "serviceName": name,
                "replicas": 0 if spec.get("suspend") else 1,
                "selector": {"matchLabels": {LABEL_NOTEBOOK: name}},
                "template": template,
            },
        }
        sts["metadata"]["ownerReferences"] = [k8s.object_ref(nb)]
        return sts

    def _update_status(self, nb: dict) -> None:
        """Mirror the pods' state into status: Running pods count as
        ready, and the first container's state is copied whole."""
        name = nb["metadata"]["name"]
        ns = nb["metadata"]["namespace"]
        pods = self.client.list(
            "v1", "Pod", ns, label_selector={LABEL_NOTEBOOK: name}
        )
        status: dict = {"readyReplicas": 0, "containerState": {}}
        for pod in pods:
            phase = pod.get("status", {}).get("phase")
            if phase == "Running":
                status["readyReplicas"] += 1
            cstates = pod.get("status", {}).get("containerStatuses", [])
            if cstates:
                status["containerState"] = cstates[0].get("state", {})
        nb = copy.deepcopy(nb)
        nb["status"] = status
        self._push_status(nb)  # refetch-and-reapply on conflict
