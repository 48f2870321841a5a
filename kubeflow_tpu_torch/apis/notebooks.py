"""The Notebook CR's names the dashboards read; the constants of
``kubeflow_tpu/apis/notebooks.py`` (the port runs no notebook
controller)."""

from kubeflow_tpu_torch.apis import API_GROUP

NOTEBOOK_KIND = "Notebook"
NOTEBOOKS_API_VERSION = f"{API_GROUP}/v1"
