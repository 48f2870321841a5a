"""The Workflow CR's names the central dashboard's activity feed reads;
the constants of ``kubeflow_tpu/apis/pipelines.py`` (the port runs no
pipeline controller)."""

from kubeflow_tpu_torch.apis import API_GROUP

PIPELINES_API_VERSION = f"{API_GROUP}/v1"
WORKFLOW_KIND = "Workflow"
