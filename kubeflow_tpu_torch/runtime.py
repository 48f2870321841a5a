"""What the port's entry points share: the glog flags they drop, the
apiserver client they build from their flags, and the managers' parser
and run loop with its leader election (the operators', the scheduler's
and the notebook controller's); the part of
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
import sys
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


def run_manager(controllers: list, args, client) -> int:
    """The manager's run, from :func:`manager_args`' flags: one pass of
    every controller (``--once``: print the count line), or poll them
    until SIGTERM/SIGINT with ``/healthz`` and ``/metrics`` on
    ``--metrics-port`` (0: none). With ``--leader-elect`` it first waits
    for the Lease ``--leader-elect-name`` in ``--namespace`` (JAX's
    ``controller_main``), renews it in the background, releases it on
    exit and returns 1 once leadership is lost: a deposed leader must
    not reconcile beside the new one."""
    from kubeflow_tpu_torch.operators.base import (
        OPERATOR_METRICS,
        HealthServer,
        run_polling,
    )

    if args.once:
        print(json.dumps({
            "reconciled": sum(reconcile_once(c) for c in controllers),
            "controllers": len(controllers)}))
        return 0
    stop, lost = threading.Event(), threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    elector = None
    if args.leader_elect:
        from kubeflow_tpu_torch.operators.leader import LeaderElector

        elector = LeaderElector(client, name=args.leader_elect_name,
                                namespace=args.namespace)
        log.info("waiting for leadership on lease %s as %s",
                 args.leader_elect_name, elector.identity)
        while not elector.try_acquire():
            if stop.wait(elector.renew_seconds):
                return 0
        elector.start()  # keep renewing in the background

        def watch() -> None:
            while not stop.wait(1.0):
                if not elector.is_leader:
                    log.error("lost leadership on lease %s; shutting down",
                              args.leader_elect_name)
                    lost.set()
                    stop.set()

        threading.Thread(target=watch, name="lease-watch",
                         daemon=True).start()
    health = None
    if args.metrics_port:
        health = HealthServer(
            args.metrics_port,
            lambda: {"kubeflow_tpu_controllers_running": len(controllers)},
            registries=(OPERATOR_METRICS,))
        health.start()
    try:
        log.info("running %d controllers: %s", len(controllers),
                 ", ".join(c.kind for c in controllers))
        run_polling(controllers, stop)
    finally:
        if elector is not None:
            elector.release()
        if health is not None:
            health.stop()
    return 1 if lost.is_set() else 0


def manager_args(prog: str, description: str,
                 default_metrics_port: int = 8443,
                 lease_name: str = "") -> argparse.ArgumentParser:
    """The parser every manager of the port shares: the client flags,
    ``--once``, ``--metrics-port``, ``--leader-elect`` and
    ``--leader-elect-name`` (default ``lease_name``, the lease JAX's
    counterpart elects on, so the two managers, which must never both
    run, also exclude each other)."""
    p = argparse.ArgumentParser(prog=prog, description=description)
    add_client_args(p)
    p.add_argument("--once", action="store_true",
                   help="one reconcile pass over every object, then exit")
    p.add_argument("--metrics-port", type=int, default=default_metrics_port,
                   help="health/metrics port (0 = disabled)")
    p.add_argument("--leader-elect", action="store_true",
                   help="hold a coordination.k8s.io Lease before "
                        "reconciling (replicated manager Deployments)")
    p.add_argument("--leader-elect-name", default=lease_name,
                   help=f"lease name (default {lease_name})")
    return p


def manager_main(argv, prog: str, description: str, make_controllers, *,
                 default_metrics_port: int = 8443, lease_name: str = "",
                 add_args=None) -> int:
    """A manager's ``main``: :func:`manager_args` (plus ``add_args(p)``'s
    flags), the client, ``make_controllers(client, args)`` and
    :func:`run_manager`, as JAX's ``controller_main`` does for its
    managers."""
    argv = strip_glog_args(list(sys.argv[1:] if argv is None else argv))
    p = manager_args(prog, description, default_metrics_port, lease_name)
    if add_args is not None:
        add_args(p)
    args = p.parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    client = client_from_args(args)
    return run_manager(make_controllers(client, args), args, client)
