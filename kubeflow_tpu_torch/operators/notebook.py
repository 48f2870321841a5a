"""``python -m kubeflow_tpu_torch.operators.notebook``: the notebook
controller alone, as ``python -m kubeflow_tpu.operators.notebook`` is
JAX's (the ``gpu-notebook-controller`` Deployment runs it).

Flags are the manager's (``runtime.manager_args``): ``--apiserver``,
``--once`` (one pass, printing ``{"reconciled": n, "controllers": 1}``),
``--metrics-port`` (default 8443) and ``--leader-elect
[--leader-elect-name NAME]`` (default JAX's ``kubeflow-tpu-notebook``).
Host code only: no torch, no GPU.
"""

from __future__ import annotations

from kubeflow_tpu_torch.runtime import manager_main


def make_controllers(client) -> list:
    from kubeflow_tpu_torch.operators.notebooks import NotebookController

    return [NotebookController(client)]


def main(argv=None) -> int:
    return manager_main(argv,
                        "python -m kubeflow_tpu_torch.operators.notebook",
                        __doc__, lambda client, args: make_controllers(client),
                        lease_name="kubeflow-tpu-notebook")


if __name__ == "__main__":
    raise SystemExit(main())
