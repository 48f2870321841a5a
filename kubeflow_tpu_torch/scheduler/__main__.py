"""``python -m kubeflow_tpu_torch.scheduler``: the split-out cluster
scheduler, as ``python -m kubeflow_tpu.scheduler`` is JAX's: one
SchedulerController against the apiserver, so placement policy rolls
independently of the job controllers (the manager,
``python -m kubeflow_tpu_torch.operators``, also runs one for
single-manager deployments; deploy one or the other).

Flags are the manager's: ``--apiserver`` (else the in-cluster service
account, else ``kubectl proxy``'s address), ``--once`` (one round,
printing ``{"reconciled": n, "controllers": 1}``), ``--metrics-port``
(default 8444, the ``gpu-scheduler`` Deployment's metrics port) and
``--leader-elect [--leader-elect-name NAME]`` (hold the Lease NAME,
default JAX's scheduler's ``kubeflow-tpu-cluster``, before placing
anything; ``gpu-scheduler`` renders it for ``replicas`` above 1). It
runs on the port's polling runtime: a round at the policy's period.
"""

from __future__ import annotations

from kubeflow_tpu_torch.runtime import manager_main


def make_controllers(client) -> list:
    from kubeflow_tpu_torch.scheduler.controller import SchedulerController

    return [SchedulerController(client)]


def main(argv=None) -> int:
    return manager_main(argv, "python -m kubeflow_tpu_torch.scheduler",
                        __doc__, lambda client, args: make_controllers(client),
                        default_metrics_port=8444,
                        lease_name="kubeflow-tpu-cluster")


if __name__ == "__main__":
    raise SystemExit(main())
