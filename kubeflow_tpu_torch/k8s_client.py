"""The part of the apiserver client the training loop uses; a standard
library copy of ``kubeflow_tpu/k8s/client.py``'s ``HttpK8sClient`` (GET and
``update_status``), over ``urllib.request`` (the GPU image has no
``requests``).

Paths are the apiserver's: ``/api/v1/...`` for the core group,
``/apis/<group>/<version>/...`` otherwise, namespaced kinds under
``/namespaces/<ns>/``; the status subresource is ``.../status``. A reply of
status 400 or above raises :class:`ApiError` with the apiserver's
``reason`` and ``message``; a connection that fails raises ``OSError``.
"""

from __future__ import annotations

import json
import ssl
import urllib.error
import urllib.request
from dataclasses import dataclass

from kubeflow_tpu_torch.apis import JOB_PLURALS

TIMEOUT_S = 60


class ApiError(Exception):
    """A Kubernetes-style API error with its HTTP status code."""

    def __init__(self, code: int, reason: str, message: str = ""):
        super().__init__(f"{code} {reason}: {message}")
        self.code = code
        self.reason = reason
        self.message = message


@dataclass
class ClusterConfig:
    """Where the apiserver is (``kubectl proxy``'s address by default),
    the bearer token, and ``verify``: True (the system's CAs), a CA
    bundle's path, or False."""

    host: str = "http://127.0.0.1:8001"
    token: str | None = None
    verify: bool | str = True


class KindRegistry:
    """Kind -> (REST plural, namespaced): the job kinds, whose CRDs are
    namespaced (what JAX's client learns from their CRDs)."""

    def __init__(self) -> None:
        self._kinds = {k: (p, True) for k, p in JOB_PLURALS.items()}

    def _lookup(self, kind: str) -> tuple[str, bool]:
        try:
            return self._kinds[kind]
        except KeyError:
            raise ApiError(404, "NotFound",
                           f"no REST mapping for kind {kind}") from None

    def plural(self, kind: str) -> str:
        return self._lookup(kind)[0]

    def namespaced(self, kind: str) -> bool:
        return self._lookup(kind)[1]


def _api_prefix(api_version: str) -> str:
    return (f"/api/{api_version}" if "/" not in api_version
            else f"/apis/{api_version}")


class HttpK8sClient:
    """GET and ``update_status`` against an apiserver over HTTP(S)."""

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

    def _request(self, method: str, path: str, body: dict | None = None
                 ) -> dict:
        headers = {"Content-Type": "application/json"}
        if self._cfg.token:
            headers["Authorization"] = f"Bearer {self._cfg.token}"
        data = None if body is None else json.dumps(body).encode()
        req = urllib.request.Request(self._cfg.host + path, data=data,
                                     headers=headers, method=method)
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

    def get(self, api_version: str, kind: str, name: str,
            namespace: str | None = None) -> dict:
        return self._request("GET",
                             self._path(api_version, kind, namespace, name))

    def update_status(self, obj: dict) -> dict:
        m = obj["metadata"]
        path = self._path(obj["apiVersion"], obj["kind"], m.get("namespace"),
                          m["name"]) + "/status"
        return self._request("PUT", path, body=obj)
