"""``python -m kubeflow_tpu_torch.operators``: the port's controllers
against an apiserver; counterpart of ``kubeflow_tpu/operators/__main__.py``
for the controllers the port has: the Experiment controller, the
InferenceService controller (replicas rendered from ``gpu-serving``, the
router annotation, the autoscaler scraping each replica's exposition over
HTTP) and the RolloutController (over the fleets registered in this
process, as JAX's manager runs it).

It polls each controller's ``reconcile_all`` (the port's client has no
watch) at the soonest of its ``resync_seconds`` and the requeue its last
pass asked for (the autoscaler's scrape period), and serves ``/healthz``
and ``/metrics`` (the operator families) on ``--metrics-port``. The
apiserver comes from ``--apiserver`` (or ``KUBEFLOW_TPU_APISERVER``),
else the in-cluster service account, else ``kubectl proxy``'s
``http://127.0.0.1:8001``, as in JAX. In-process trials run on the card
unless ``--device cpu``; job-mode trials render JaxJobs on the port's
image. ``--once`` makes one pass of every controller and prints
``{"reconciled": n, "controllers": 3}``, ``n`` the objects of all three;
a kind the apiserver does not serve (its CRD not installed) counts 0.
"""

from __future__ import annotations

import argparse
import functools
import json
import logging
import signal
import sys
import threading

from kubeflow_tpu_torch.k8s_client import ApiError
from kubeflow_tpu_torch.operators.base import (
    OPERATOR_METRICS,
    HealthServer,
    run_polling,
)
from kubeflow_tpu_torch.runtime import (
    add_client_args,
    client_from_args,
    strip_glog_args,
)

log = logging.getLogger(__name__)

def make_controllers(client, device: str = "cuda") -> list:
    """The manager's controllers, in JAX's manager's order."""
    from kubeflow_tpu_torch.operators.experiment import (
        ExperimentController,
        _default_run_trial,
    )
    from kubeflow_tpu_torch.operators.inference import (
        InferenceServiceController,
    )
    from kubeflow_tpu_torch.operators.rollout import RolloutController

    return [InferenceServiceController(client), RolloutController(client),
            ExperimentController(client, run_trial=functools.partial(
                _default_run_trial, device=device))]


def reconcile_once(controller) -> int:
    """One pass; 0 where the apiserver does not serve the kind."""
    try:
        return controller.reconcile_all()
    except ApiError as e:
        if e.code != 404:
            raise
        log.warning("%s is not served (%s): nothing to reconcile",
                    controller.kind, e)
        return 0


def main(argv=None) -> int:
    argv = strip_glog_args(list(sys.argv[1:] if argv is None else argv))
    p = argparse.ArgumentParser(prog="python -m kubeflow_tpu_torch.operators",
                                description=__doc__)
    add_client_args(p)
    p.add_argument("--once", action="store_true",
                   help="one reconcile pass over every object, then exit")
    p.add_argument("--metrics-port", type=int, default=8443,
                   help="health/metrics port (0 = disabled)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where in-process trials run")
    args = p.parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")

    client = client_from_args(args)
    controllers = make_controllers(client, args.device)
    if args.once:
        print(json.dumps({
            "reconciled": sum(reconcile_once(c) for c in controllers),
            "controllers": len(controllers)}))
        return 0
    health = None
    if args.metrics_port:
        health = HealthServer(
            args.metrics_port,
            lambda: {"kubeflow_tpu_controllers_running": len(controllers)},
            registries=(OPERATOR_METRICS,))
        health.start()
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    try:
        run_polling(controllers, stop)
    finally:
        if health is not None:
            health.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
