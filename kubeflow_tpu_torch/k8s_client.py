"""The part of the apiserver client the port uses; a standard library copy
of ``kubeflow_tpu/k8s/client.py`` (``ApiError``, ``KindRegistry``, the
``K8sClient`` surface, ``retry_on_conflict``) with its
``HttpK8sClient`` over ``urllib.request`` (the GPU image has no
``requests``) and no watch: the training loop GETs its job and writes its
status, the Experiment controller lists, gets, creates, replaces and
deletes (``operators/experiment.py``, polled by ``python -m
kubeflow_tpu_torch.operators``).

Paths are the apiserver's: ``/api/v1/...`` for the core group,
``/apis/<group>/<version>/...`` otherwise, namespaced kinds under
``/namespaces/<ns>/``; the status subresource is ``.../status``. A reply of
status 400 or above raises :class:`ApiError` with the apiserver's
``reason`` and ``message``; a connection that fails raises ``OSError``.
"""

from __future__ import annotations

import copy
import json
import ssl
import threading
import urllib.error
import urllib.parse
import urllib.request
from dataclasses import dataclass
from typing import Any, Callable, Mapping

from kubeflow_tpu_torch.apis import JOB_PLURALS

TIMEOUT_S = 60


class ApiError(Exception):
    """A Kubernetes-style API error with its HTTP status code."""

    def __init__(self, code: int, reason: str, message: str = ""):
        super().__init__(f"{code} {reason}: {message}")
        self.code = code
        self.reason = reason
        self.message = message

    @classmethod
    def not_found(cls, what: str) -> "ApiError":
        return cls(404, "NotFound", what)

    @classmethod
    def conflict(cls, what: str) -> "ApiError":
        return cls(409, "Conflict", what)

    @classmethod
    def already_exists(cls, what: str) -> "ApiError":
        return cls(409, "AlreadyExists", what)

    @classmethod
    def invalid(cls, what: str) -> "ApiError":
        return cls(422, "Invalid", what)


# Kind -> (plural, namespaced): the built-in kinds JAX's client knows, the
# job kinds (namespaced CRDs) and the CRs the Experiment controller reads
# and writes, so a real-cluster client resolves them without discovery.
_KNOWN_KINDS: dict[str, tuple[str, bool]] = {
    "Pod": ("pods", True),
    "Service": ("services", True),
    "ConfigMap": ("configmaps", True),
    "Secret": ("secrets", True),
    "Namespace": ("namespaces", False),
    "Node": ("nodes", False),
    "PersistentVolumeClaim": ("persistentvolumeclaims", True),
    "ResourceQuota": ("resourcequotas", True),
    "ServiceAccount": ("serviceaccounts", True),
    "Deployment": ("deployments", True),
    "StatefulSet": ("statefulsets", True),
    "Job": ("jobs", True),
    "CronJob": ("cronjobs", True),
    "Event": ("events", True),
    "Lease": ("leases", True),
    "Role": ("roles", True),
    "RoleBinding": ("rolebindings", True),
    "ClusterRole": ("clusterroles", False),
    "ClusterRoleBinding": ("clusterrolebindings", False),
    "CustomResourceDefinition": ("customresourcedefinitions", False),
    **{k: (p, True) for k, p in JOB_PLURALS.items()},
    "Experiment": ("experiments", True),
    "InferenceService": ("inferenceservices", True),
}


class KindRegistry:
    """Kind -> REST plural and scope, and each CRD's served and storage
    versions, extended when a CRD is applied. Kinds whose versions share
    one schema convert by an apiVersion rewrite (JAX's registry also
    holds the job kinds' v1beta1 converter, which nothing of the port
    reads through)."""

    def __init__(self) -> None:
        self._kinds = dict(_KNOWN_KINDS)
        # kind -> (group, {version: served}, storage_version)
        self._versions: dict[str, tuple[str, dict[str, bool], str]] = {}
        self._lock = threading.Lock()

    def register_crd(self, crd_obj: Mapping[str, Any]) -> None:
        spec = crd_obj["spec"]
        kind = spec["names"]["kind"]
        plural = spec["names"]["plural"]
        namespaced = spec.get("scope", "Namespaced") == "Namespaced"
        group = spec.get("group", "")
        served: dict[str, bool] = {}
        storage = ""
        for v in spec.get("versions", []):
            served[v["name"]] = bool(v.get("served", True))
            if v.get("storage"):
                storage = v["name"]
        with self._lock:
            self._kinds[kind] = (plural, namespaced)
            if group and storage:
                self._versions[kind] = (group, served, storage)

    def storage_api_version(self, kind: str) -> str | None:
        with self._lock:
            info = self._versions.get(kind)
        return f"{info[0]}/{info[2]}" if info else None

    def served(self, kind: str, api_version: str) -> bool:
        with self._lock:
            info = self._versions.get(kind)
        if info is None:
            return True
        group, versions, _storage = info
        g, _, v = api_version.rpartition("/")
        return g == group and versions.get(v, False)

    @staticmethod
    def convert(obj: dict, to_api_version: str) -> dict:
        if obj.get("apiVersion") == to_api_version:
            return obj
        out = copy.deepcopy(obj)
        out["apiVersion"] = to_api_version
        return out

    def _lookup(self, kind: str) -> tuple[str, bool]:
        try:
            with self._lock:
                return self._kinds[kind]
        except KeyError:
            raise ApiError.not_found(
                f"no REST mapping for kind {kind}") from None

    def plural(self, kind: str) -> str:
        return self._lookup(kind)[0]

    def namespaced(self, kind: str) -> bool:
        return self._lookup(kind)[1]


class K8sClient:
    """The CRUD surface the port's controllers are written against, and
    the conveniences every backend shares."""

    def create(self, obj: dict) -> dict:
        raise NotImplementedError

    def get(self, api_version: str, kind: str, name: str,
            namespace: str | None = None) -> dict:
        raise NotImplementedError

    def list(self, api_version: str, kind: str,
             namespace: str | None = None,
             label_selector: Mapping[str, str] | None = None) -> list[dict]:
        raise NotImplementedError

    def update(self, obj: dict) -> dict:
        raise NotImplementedError

    def update_status(self, obj: dict) -> dict:
        raise NotImplementedError

    def delete(self, api_version: str, kind: str, name: str,
               namespace: str | None = None) -> None:
        raise NotImplementedError

    def apply(self, obj: dict) -> dict:
        """Create-or-update."""
        m = obj["metadata"]
        try:
            existing = self.get(
                obj["apiVersion"], obj["kind"], m["name"], m.get("namespace"))
        except ApiError as e:
            if e.code != 404:
                raise
            return self.create(obj)
        merged = copy.deepcopy(obj)
        merged["metadata"]["resourceVersion"] = existing["metadata"].get(
            "resourceVersion")
        return self.update(merged)

    def get_or_none(self, api_version: str, kind: str, name: str,
                    namespace: str | None = None) -> dict | None:
        try:
            return self.get(api_version, kind, name, namespace)
        except ApiError as e:
            if e.code == 404:
                return None
            raise


def match_labels(obj: Mapping[str, Any],
                 selector: Mapping[str, str] | None) -> bool:
    if not selector:
        return True
    labels = obj.get("metadata", {}).get("labels", {}) or {}
    return all(labels.get(k) == v for k, v in selector.items())


def retry_on_conflict(client: K8sClient, fn: Callable[[K8sClient], Any],
                      attempts: int = 5) -> Any:
    """Run ``fn(client)`` and retry it on 409 Conflict. ``fn`` must
    refetch the object it changes inside the call, so every attempt races
    against fresh state."""
    for attempt in range(attempts):
        try:
            return fn(client)
        except ApiError as e:
            if e.code != 409 or attempt == attempts - 1:
                raise


@dataclass
class ClusterConfig:
    """Where the apiserver is (``kubectl proxy``'s address by default),
    the bearer token, and ``verify``: True (the system's CAs), a CA
    bundle's path, or False."""

    host: str = "http://127.0.0.1:8001"
    token: str | None = None
    verify: bool | str = True


def _api_prefix(api_version: str) -> str:
    return (f"/api/{api_version}" if "/" not in api_version
            else f"/apis/{api_version}")


class HttpK8sClient(K8sClient):
    """CRUD against an apiserver over HTTP(S)."""

    def __init__(self, config: ClusterConfig | None = None,
                 registry: KindRegistry | None = None):
        self._cfg = config or ClusterConfig()
        self._registry = registry or KindRegistry()
        verify = self._cfg.verify
        context = (ssl.create_default_context(cafile=verify)
                   if isinstance(verify, str)
                   else ssl.create_default_context())
        if verify is False:
            context.check_hostname = False
            context.verify_mode = ssl.CERT_NONE
        # The apiserver is reached directly, never through a proxy the
        # environment names.
        self._opener = urllib.request.build_opener(
            urllib.request.ProxyHandler({}),
            urllib.request.HTTPSHandler(context=context))

    def _path(self, api_version: str, kind: str, namespace: str | None,
              name: str | None = None) -> str:
        parts = [_api_prefix(api_version)]
        if self._registry.namespaced(kind) and namespace:
            parts.append(f"/namespaces/{namespace}")
        parts.append(f"/{self._registry.plural(kind)}")
        if name:
            parts.append(f"/{name}")
        return "".join(parts)

    def _request(self, method: str, path: str, body: dict | None = None,
                 params: Mapping[str, str] | None = None) -> dict:
        headers = {"Content-Type": "application/json"}
        if self._cfg.token:
            headers["Authorization"] = f"Bearer {self._cfg.token}"
        data = None if body is None else json.dumps(body).encode()
        url = self._cfg.host + path
        if params:
            url += "?" + urllib.parse.urlencode(params)
        req = urllib.request.Request(url, data=data, headers=headers,
                                     method=method)
        try:
            with self._opener.open(req, timeout=TIMEOUT_S) as resp:
                raw = resp.read()
        except urllib.error.HTTPError as e:
            text = e.read().decode(errors="replace")
            try:
                status = json.loads(text)
            except ValueError:
                raise ApiError(e.code, "Error", text) from None
            raise ApiError(e.code, status.get("reason", "Error"),
                           status.get("message", text)) from None
        return json.loads(raw) if raw else {}

    def create(self, obj: dict) -> dict:
        m = obj["metadata"]
        created = self._request(
            "POST", self._path(obj["apiVersion"], obj["kind"],
                               m.get("namespace")), body=obj)
        if obj["kind"] == "CustomResourceDefinition":
            self._registry.register_crd(obj)
        return created

    def get(self, api_version: str, kind: str, name: str,
            namespace: str | None = None) -> dict:
        return self._request("GET",
                             self._path(api_version, kind, namespace, name))

    def list(self, api_version: str, kind: str,
             namespace: str | None = None,
             label_selector: Mapping[str, str] | None = None) -> list[dict]:
        params = {}
        if label_selector:
            params["labelSelector"] = ",".join(
                f"{k}={v}" for k, v in label_selector.items())
        result = self._request("GET", self._path(api_version, kind,
                                                 namespace), params=params)
        items = result.get("items", [])
        for it in items:  # list items omit apiVersion/kind; restore them
            it.setdefault("apiVersion", api_version)
            it.setdefault("kind", kind)
        return items

    def update(self, obj: dict) -> dict:
        m = obj["metadata"]
        updated = self._request(
            "PUT", self._path(obj["apiVersion"], obj["kind"],
                              m.get("namespace"), m["name"]), body=obj)
        if obj["kind"] == "CustomResourceDefinition":
            self._registry.register_crd(obj)
        return updated

    def update_status(self, obj: dict) -> dict:
        m = obj["metadata"]
        path = self._path(obj["apiVersion"], obj["kind"], m.get("namespace"),
                          m["name"]) + "/status"
        return self._request("PUT", path, body=obj)

    def delete(self, api_version: str, kind: str, name: str,
               namespace: str | None = None) -> None:
        self._request("DELETE",
                      self._path(api_version, kind, namespace, name))
