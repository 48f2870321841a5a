"""``python -m kubeflow_tpu_torch.operators``: the port's Experiment
controller against an apiserver; counterpart of
``kubeflow_tpu/operators/__main__.py`` for the one controller the port
has.

It reconciles every Experiment each ``resync_seconds`` (a poll: the
port's client has no watch) and serves ``/healthz`` and ``/metrics``
(the operator families) on ``--metrics-port``. The apiserver comes from
``--apiserver`` (or ``KUBEFLOW_TPU_APISERVER``), else the in-cluster
service account, else ``kubectl proxy``'s ``http://127.0.0.1:8001``, as
in JAX. In-process trials run on the card unless ``--device cpu``;
job-mode trials render JaxJobs on the port's image. ``--once`` makes
one pass and prints ``{"reconciled": n}``.
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

from kubeflow_tpu_torch.k8s_client import ClusterConfig, HttpK8sClient
from kubeflow_tpu_torch.operators.base import (
    OPERATOR_METRICS,
    HealthServer,
    run_polling,
)

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
                   help="one reconcile pass over every Experiment, then exit")
    p.add_argument("--metrics-port", type=int, default=8443,
                   help="health/metrics port (0 = disabled)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where in-process trials run")
    args = p.parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")

    from kubeflow_tpu_torch.operators.experiment import (
        ExperimentController,
        _default_run_trial,
    )

    client = HttpK8sClient(cluster_config(args.apiserver, args.token_path))
    ctrl = ExperimentController(client, run_trial=functools.partial(
        _default_run_trial, device=args.device))
    if args.once:
        print(json.dumps({"reconciled": ctrl.reconcile_all(),
                          "controllers": 1}))
        return 0
    health = None
    if args.metrics_port:
        health = HealthServer(
            args.metrics_port,
            lambda: {"kubeflow_tpu_controllers_running": 1},
            registries=(OPERATOR_METRICS,))
        health.start()
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    try:
        run_polling([ctrl], stop)
    finally:
        if health is not None:
            health.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
