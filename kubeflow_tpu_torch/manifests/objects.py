"""Builders for the Kubernetes objects the port's prototypes and its
Experiment controller emit: a copy of the helpers of
``kubeflow_tpu/k8s/objects.py`` that they use (standard library only),
kept in this package so the port imports nothing of the JAX one.

Objects are plain dicts; optional arguments left as None vanish from the
output.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

def _clean(d: dict) -> dict:
    """Drop None-valued keys so optional arguments vanish from output."""
    return {k: v for k, v in d.items() if v is not None}


def metadata(
    name: str,
    namespace: str | None = None,
    labels: Mapping[str, str] | None = None,
    annotations: Mapping[str, str] | None = None,
) -> dict:
    return _clean(
        {
            "name": name,
            "namespace": namespace,
            "labels": dict(labels) if labels else None,
            "annotations": dict(annotations) if annotations else None,
        }
    )


def object_ref(obj: Mapping[str, Any]) -> dict:
    """An ownerReference to `obj` (controller=true, like controller-runtime)."""
    return {
        "apiVersion": obj["apiVersion"],
        "kind": obj["kind"],
        "name": obj["metadata"]["name"],
        "uid": obj["metadata"].get("uid", ""),
        "controller": True,
        "blockOwnerDeletion": True,
    }


def container(
    name: str,
    image: str,
    command: Sequence[str] | None = None,
    args: Sequence[str] | None = None,
    env: Mapping[str, str] | None = None,
    env_from_field: Mapping[str, str] | None = None,
    ports: Mapping[str, int] | None = None,
    resources: Mapping[str, Any] | None = None,
    volume_mounts: Sequence[Mapping[str, str]] | None = None,
    working_dir: str | None = None,
    liveness_probe: dict | None = None,
    readiness_probe: dict | None = None,
    image_pull_policy: str | None = None,
) -> dict:
    """A container spec. ``env`` maps name->literal value;
    ``env_from_field`` maps name->fieldPath (downward API); ``ports`` maps
    port-name -> containerPort."""
    env_list: list[dict] = []
    for k, v in (env or {}).items():
        env_list.append({"name": k, "value": str(v)})
    for k, path in (env_from_field or {}).items():
        env_list.append({"name": k, "valueFrom": {"fieldRef": {"fieldPath": path}}})
    return _clean(
        {
            "name": name,
            "image": image,
            "command": list(command) if command else None,
            "args": list(args) if args else None,
            "workingDir": working_dir,
            "env": env_list or None,
            "ports": [
                {"name": n, "containerPort": p} for n, p in (ports or {}).items()
            ]
            or None,
            "resources": dict(resources) if resources else None,
            "volumeMounts": [dict(v) for v in volume_mounts] if volume_mounts else None,
            "livenessProbe": liveness_probe,
            "readinessProbe": readiness_probe,
            "imagePullPolicy": image_pull_policy,
        }
    )


def tcp_probe(port: int, initial_delay: int = 15, period: int = 10) -> dict:
    return {
        "tcpSocket": {"port": port},
        "initialDelaySeconds": initial_delay,
        "periodSeconds": period,
    }


def http_probe(path: str, port: int, initial_delay: int = 10, period: int = 10) -> dict:
    return {
        "httpGet": {"path": path, "port": port},
        "initialDelaySeconds": initial_delay,
        "periodSeconds": period,
    }


def pod_spec(
    containers: Sequence[dict],
    service_account: str | None = None,
    volumes: Sequence[dict] | None = None,
    node_selector: Mapping[str, str] | None = None,
    restart_policy: str | None = None,
    scheduler_name: str | None = None,
    host_network: bool | None = None,
    subdomain: str | None = None,
    hostname: str | None = None,
    tolerations: Sequence[dict] | None = None,
    init_containers: Sequence[dict] | None = None,
) -> dict:
    return _clean(
        {
            "containers": list(containers),
            "initContainers": list(init_containers) if init_containers else None,
            "serviceAccountName": service_account,
            "volumes": list(volumes) if volumes else None,
            "nodeSelector": dict(node_selector) if node_selector else None,
            "restartPolicy": restart_policy,
            "schedulerName": scheduler_name,
            "hostNetwork": host_network,
            "subdomain": subdomain,
            "hostname": hostname,
            "tolerations": list(tolerations) if tolerations else None,
        }
    )


def deployment(
    name: str,
    namespace: str,
    containers: Sequence[dict],
    replicas: int = 1,
    labels: Mapping[str, str] | None = None,
    pod_labels: Mapping[str, str] | None = None,
    pod_annotations: Mapping[str, str] | None = None,
    service_account: str | None = None,
    volumes: Sequence[dict] | None = None,
    node_selector: Mapping[str, str] | None = None,
) -> dict:
    pod_labels = dict(pod_labels or labels or {"app": name})
    return {
        "apiVersion": "apps/v1",
        "kind": "Deployment",
        "metadata": metadata(name, namespace, labels),
        "spec": {
            "replicas": replicas,
            "selector": {"matchLabels": pod_labels},
            "template": {
                "metadata": _clean(
                    {
                        "labels": pod_labels,
                        "annotations": dict(pod_annotations)
                        if pod_annotations
                        else None,
                    }
                ),
                "spec": pod_spec(
                    containers,
                    service_account=service_account,
                    volumes=volumes,
                    node_selector=node_selector,
                ),
            },
        },
    }


def service(
    name: str,
    namespace: str,
    selector: Mapping[str, str],
    ports: Sequence[Mapping[str, Any]],
    labels: Mapping[str, str] | None = None,
    annotations: Mapping[str, str] | None = None,
    cluster_ip: str | None = None,
    service_type: str | None = None,
) -> dict:
    return {
        "apiVersion": "v1",
        "kind": "Service",
        "metadata": metadata(name, namespace, labels, annotations),
        "spec": _clean(
            {
                "selector": dict(selector),
                "ports": [dict(p) for p in ports],
                "clusterIP": cluster_ip,
                "type": service_type,
            }
        ),
    }


def crd(
    group: str,
    kind: str,
    plural: str,
    versions: Sequence[dict],
    scope: str = "Namespaced",
    short_names: Sequence[str] | None = None,
    categories: Sequence[str] | None = None,
    conversion: dict | None = None,
) -> dict:
    """A CustomResourceDefinition (apiextensions v1)."""
    return {
        "apiVersion": "apiextensions.k8s.io/v1",
        "kind": "CustomResourceDefinition",
        "metadata": metadata(f"{plural}.{group}"),
        "spec": _clean(
            {
                "group": group,
                "scope": scope,
                "names": _clean(
                    {
                        "kind": kind,
                        "plural": plural,
                        "singular": kind.lower(),
                        "shortNames": list(short_names) if short_names else None,
                        "categories": list(categories) if categories else None,
                    }
                ),
                "versions": list(versions),
                "conversion": conversion,
            }
        ),
    }


def crd_version(
    name: str,
    schema: dict | None = None,
    served: bool = True,
    storage: bool = False,
    printer_columns: Sequence[dict] | None = None,
    status_subresource: bool = True,
) -> dict:
    v: dict = {"name": name, "served": served, "storage": storage}
    if status_subresource:
        v["subresources"] = {"status": {}}
    if schema is not None:
        v["schema"] = {"openAPIV3Schema": schema}
    if printer_columns:
        v["additionalPrinterColumns"] = list(printer_columns)
    return v


def printer_column(name: str, json_path: str, col_type: str = "string") -> dict:
    return {"name": name, "type": col_type, "jsonPath": json_path}
