"""What the port's entry points share: the glog flags they drop, the
apiserver client they build from their flags, and the managers' parser
and run loop (the operators' and the scheduler's); the part of
``kubeflow_tpu/runtime.py`` the port's binaries use (the operators, the
gateway, the dashboards and the job workloads).

The apiserver comes from ``--apiserver`` (or ``KUBEFLOW_TPU_APISERVER``),
else the in-cluster service account, else ``kubectl proxy``'s
``http://127.0.0.1:8001``, as in JAX. Standard library only: a gateway or
dashboard pod imports neither torch nor JAX.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import signal
import threading

from kubeflow_tpu_torch.k8s_client import (
    ApiError,
    ClusterConfig,
    HttpK8sClient,
)

log = logging.getLogger(__name__)

IN_CLUSTER_TOKEN = "/var/run/secrets/kubernetes.io/serviceaccount/token"
IN_CLUSTER_CA = "/var/run/secrets/kubernetes.io/serviceaccount/ca.crt"


def strip_glog_args(argv: list[str]) -> list[str]:
    """Drop the glog-style flags the operators' manifests pass
    (``--alsologtostderr -v=1``), so the argparse entry points accept the
    manifests' args."""
    return [a for a in argv if a != "--alsologtostderr"
            and not a.startswith(("-v=", "--v="))]


def add_client_args(p: argparse.ArgumentParser) -> None:
    """JAX's client flags: ``--apiserver``, ``--token-path`` and
    ``--namespace``."""
    p.add_argument(
        "--apiserver",
        default=os.environ.get("KUBEFLOW_TPU_APISERVER", ""),
        help="apiserver URL; empty = in-cluster config, falling back to "
             "the kubectl-proxy default http://127.0.0.1:8001")
    p.add_argument("--token-path", default="",
                   help="bearer token file (default: in-cluster SA token)")
    p.add_argument("--namespace", default=os.environ.get(
        "KUBEFLOW_TPU_NAMESPACE", "kubeflow"))


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


def client_from_args(args) -> HttpK8sClient:
    """The client ``add_client_args``' flags name; its registry knows
    every kind the port's binaries read (``k8s_client._KNOWN_KINDS``)."""
    return HttpK8sClient(cluster_config(args.apiserver, args.token_path))


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


def run_manager(controllers: list, *, once: bool, metrics_port: int) -> int:
    """One pass of every controller (``once``: print the count line), or
    poll them until SIGTERM/SIGINT with ``/healthz`` and ``/metrics`` on
    ``metrics_port`` (0: none)."""
    from kubeflow_tpu_torch.operators.base import (
        OPERATOR_METRICS,
        HealthServer,
        run_polling,
    )

    if once:
        print(json.dumps({
            "reconciled": sum(reconcile_once(c) for c in controllers),
            "controllers": len(controllers)}))
        return 0
    health = None
    if metrics_port:
        health = HealthServer(
            metrics_port,
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


def manager_args(prog: str, description: str,
                 default_metrics_port: int = 8443) -> argparse.ArgumentParser:
    """The parser every manager of the port shares: the client flags,
    ``--once`` and ``--metrics-port``."""
    p = argparse.ArgumentParser(prog=prog, description=description)
    add_client_args(p)
    p.add_argument("--once", action="store_true",
                   help="one reconcile pass over every object, then exit")
    p.add_argument("--metrics-port", type=int, default=default_metrics_port,
                   help="health/metrics port (0 = disabled)")
    return p
