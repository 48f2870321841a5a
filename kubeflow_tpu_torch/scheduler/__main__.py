"""``python -m kubeflow_tpu_torch.scheduler``: the split-out cluster
scheduler, as ``python -m kubeflow_tpu.scheduler`` is JAX's: one
SchedulerController against the apiserver, so placement policy rolls
independently of the job controllers (the manager,
``python -m kubeflow_tpu_torch.operators``, also runs one for
single-manager deployments; deploy one or the other).

Flags are the manager's: ``--apiserver`` (else the in-cluster service
account, else ``kubectl proxy``'s address), ``--once`` (one round,
printing ``{"reconciled": n, "controllers": 1}``) and ``--metrics-port``
(default 8444, the ``gpu-scheduler`` Deployment's metrics port). It runs
on the port's polling runtime: a round at the policy's period. JAX's
``--leader-elect`` is not ported, so ``gpu-scheduler`` renders one
replica.
"""

from __future__ import annotations

import logging
import sys

from kubeflow_tpu_torch.runtime import (
    client_from_args,
    manager_args,
    run_manager,
    strip_glog_args,
)


def make_controllers(client) -> list:
    from kubeflow_tpu_torch.scheduler.controller import SchedulerController

    return [SchedulerController(client)]


def main(argv=None) -> int:
    argv = strip_glog_args(list(sys.argv[1:] if argv is None else argv))
    args = manager_args("python -m kubeflow_tpu_torch.scheduler", __doc__,
                        default_metrics_port=8444).parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    return run_manager(make_controllers(client_from_args(args)),
                       once=args.once, metrics_port=args.metrics_port)


if __name__ == "__main__":
    raise SystemExit(main())
