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
import os
import signal
import sys
import threading

from kubeflow_tpu_torch.k8s_client import (
    ApiError,
    ClusterConfig,
    HttpK8sClient,
)
from kubeflow_tpu_torch.operators.base import (
    OPERATOR_METRICS,
    HealthServer,
    run_polling,
)

log = logging.getLogger(__name__)

IN_CLUSTER_TOKEN = "/var/run/secrets/kubernetes.io/serviceaccount/token"
IN_CLUSTER_CA = "/var/run/secrets/kubernetes.io/serviceaccount/ca.crt"


def cluster_config(apiserver: str, token_path: str) -> ClusterConfig:
    """JAX's ``cluster_config_from_args``: an explicit URL, else the
    in-cluster service, else the kubectl-proxy default."""
    host, token, verify = apiserver, None, True
    token_path = token_path or (
        IN_CLUSTER_TOKEN if os.path.exists(IN_CLUSTER_TOKEN) else "")
    if token_path and os.path.exists(token_path):
        with open(token_path) as f:
            token = f.read().strip()
    if not host:
        k8s_host = os.environ.get("KUBERNETES_SERVICE_HOST")
        if k8s_host:
            port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
            host = f"https://{k8s_host}:{port}"
            if os.path.exists(IN_CLUSTER_CA):
                verify = IN_CLUSTER_CA
        else:
            host = "http://127.0.0.1:8001"
    return ClusterConfig(host=host, token=token, verify=verify)


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
    argv = [a for a in (sys.argv[1:] if argv is None else argv)
            if a != "--alsologtostderr" and not a.startswith(("-v=", "--v="))]
    p = argparse.ArgumentParser(prog="python -m kubeflow_tpu_torch.operators",
                                description=__doc__)
    p.add_argument("--apiserver",
                   default=os.environ.get("KUBEFLOW_TPU_APISERVER", ""))
    p.add_argument("--token-path", default="",
                   help="bearer token file (default: in-cluster SA token)")
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

    client = HttpK8sClient(cluster_config(args.apiserver, args.token_path))
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
