"""``python -m kubeflow_tpu_torch.operators``: the port's controllers
against an apiserver; counterpart of ``kubeflow_tpu/operators/__main__.py``
for the controllers the port has, in JAX's manager's order: the job
controllers (JaxJob, TFJob, PyTorchJob, MXNetJob, ChainerJob, MPIJob:
gangs, placed pods on GPU nodes), the cluster scheduler, the
InferenceService controller (replicas rendered from ``gpu-serving``, the
router annotation, the autoscaler scraping each replica's exposition over
HTTP), the RolloutController (over the fleets registered in this
process, as JAX's manager runs it), the RLJob controller, the Notebook
controller (GPU notebooks) and the Experiment controller. On a GPU
cluster this manager replaces JAX's: two managers must not reconcile the
same kinds. ``gpu-training-operator`` deploys it; with ``replicas``
above 1 it renders ``--leader-elect``, and the replicas elect on one
Lease (default JAX's manager's ``kubeflow-tpu-training-operator``).

It polls each controller's ``reconcile_all`` (the port's client has no
watch) at the soonest of its ``resync_seconds`` and the requeue its last
pass asked for (the autoscaler's scrape period), and serves ``/healthz``
and ``/metrics`` (the operator families) on ``--metrics-port``. The
apiserver comes from ``--apiserver`` (or ``KUBEFLOW_TPU_APISERVER``),
else the in-cluster service account, else ``kubectl proxy``'s
``http://127.0.0.1:8001``, as in JAX. In-process trials run on the card
unless ``--device cpu``; job-mode trials render JaxJobs on the port's
image. ``--once`` makes one pass of every controller and prints
``{"reconciled": n, "controllers": 12}``, ``n`` the objects of all
twelve;
a kind the apiserver does not serve (its CRD not installed) counts 0.
"""

from __future__ import annotations

import functools

from kubeflow_tpu_torch.runtime import manager_main


def make_controllers(client, device: str = "cuda") -> list:
    """The manager's controllers, in JAX's manager's order: the job
    controllers (one a kind), the scheduler, the InferenceService, the
    Rollout, the RLJob, the Notebook and the Experiment controller."""
    from kubeflow_tpu_torch.operators.experiment import (
        ExperimentController,
        _default_run_trial,
    )
    from kubeflow_tpu_torch.operators.inference import (
        InferenceServiceController,
    )
    from kubeflow_tpu_torch.operators.jobs import make_job_controllers
    from kubeflow_tpu_torch.operators.notebooks import NotebookController
    from kubeflow_tpu_torch.operators.rl import RLJobController
    from kubeflow_tpu_torch.operators.rollout import RolloutController
    from kubeflow_tpu_torch.scheduler.controller import SchedulerController

    return [*make_job_controllers(client), SchedulerController(client),
            InferenceServiceController(client), RolloutController(client),
            RLJobController(client), NotebookController(client),
            ExperimentController(client, run_trial=functools.partial(
                _default_run_trial, device=device))]


def main(argv=None) -> int:
    def device_arg(p) -> None:
        p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                       help="where in-process trials run")

    return manager_main(
        argv, "python -m kubeflow_tpu_torch.operators", __doc__,
        lambda client, args: make_controllers(client, args.device),
        lease_name="kubeflow-tpu-training-operator", add_args=device_arg)


if __name__ == "__main__":
    raise SystemExit(main())
