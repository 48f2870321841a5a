"""In-process fake Kubernetes apiserver; a copy of
``kubeflow_tpu/k8s/fake.py``'s ``FakeApiServer`` over the port's
:mod:`k8s_client`, for the tuning sweep (``tuning/sweep.py``), the
Experiment controller's in-process runs and the tests.

Kept from JAX's: uid / resourceVersion / creationTimestamp assignment,
optimistic-concurrency conflicts on a stale resourceVersion, merge
patches (the scheduler's placement writes), status as a
subresource (a spec update keeps the status and a status update keeps the
spec), namespace existence, label-selector lists, ownerReference cascade
deletion, and CRD registration (applying a CRD makes its kind servable at
its storage version). Left out, as nothing of the port uses them: watch
streams and the migration of stored objects when a CRD's
storage version moves.

:func:`serve` puts a fake behind the apiserver's REST paths on
127.0.0.1 (a copy of ``kubeflow_tpu/k8s/httpfake.py`` without watch), so
a process started with ``--apiserver http://127.0.0.1:<port>`` (a
manager, a pod's workload publishing its metrics) reaches it over HTTP.
"""

from __future__ import annotations

import copy
import datetime
import json
import re
import threading
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Mapping
from urllib.parse import parse_qs, urlparse

from kubeflow_tpu_torch.k8s_client import (
    ApiError,
    K8sClient,
    KindRegistry,
    match_labels,
    merge_patch,
)


def _now() -> str:
    return (
        datetime.datetime.now(datetime.timezone.utc)
        .replace(microsecond=0)
        .isoformat()
        .replace("+00:00", "Z")
    )


class FakeApiServer(K8sClient):
    def __init__(self) -> None:
        self._store: dict[tuple[str, str, str, str], dict] = {}
        self._registry = KindRegistry()
        self._lock = threading.RLock()
        self._rv = 0

    def _storage_av(self, api_version: str, kind: str) -> str:
        """The apiVersion objects of ``kind`` are stored at; an unserved
        version is rejected as a real apiserver 404s it."""
        storage = self._registry.storage_api_version(kind)
        if storage is None or api_version == storage:
            return api_version
        if not self._registry.served(kind, api_version):
            raise ApiError.not_found(
                f"{kind} is not served at {api_version}")
        return storage

    def _key(self, api_version: str, kind: str, namespace: str | None,
             name: str) -> tuple[str, str, str, str]:
        ns = namespace or "" if self._registry.namespaced(kind) else ""
        return (self._storage_av(api_version, kind), kind, ns, name)

    def _next_rv(self) -> str:
        self._rv += 1
        return str(self._rv)

    def _check_namespace(self, obj: Mapping[str, Any]) -> None:
        kind = obj["kind"]
        if not self._registry.namespaced(kind):
            return
        ns = obj["metadata"].get("namespace")
        if not ns:
            raise ApiError.invalid(
                f"{kind} {obj['metadata'].get('name')}: namespace required")
        if ("v1", "Namespace", "", ns) not in self._store:
            raise ApiError.not_found(f"namespace {ns} not found")

    def create(self, obj: dict) -> dict:
        obj = copy.deepcopy(obj)
        m = obj.setdefault("metadata", {})
        if "name" not in m and "generateName" in m:
            m["name"] = m["generateName"] + uuid.uuid4().hex[:6]
        with self._lock:
            self._check_namespace(obj)
            requested_av = obj["apiVersion"]
            key = self._key(requested_av, obj["kind"], m.get("namespace"),
                            m["name"])
            obj = self._registry.convert(obj, key[0])
            if key in self._store:
                raise ApiError.already_exists(
                    f"{obj['kind']} {m.get('namespace', '')}/{m['name']} "
                    "already exists")
            m = obj["metadata"]
            m["uid"] = str(uuid.uuid4())
            m["resourceVersion"] = self._next_rv()
            m["creationTimestamp"] = _now()
            self._store[key] = obj
            if obj["kind"] == "CustomResourceDefinition":
                self._registry.register_crd(obj)
            return self._registry.convert(copy.deepcopy(obj), requested_av)

    def get(self, api_version: str, kind: str, name: str,
            namespace: str | None = None) -> dict:
        with self._lock:
            key = self._key(api_version, kind, namespace, name)
            if key not in self._store:
                raise ApiError.not_found(
                    f"{kind} {namespace or ''}/{name} not found")
            return self._registry.convert(
                copy.deepcopy(self._store[key]), api_version)

    def list(self, api_version: str, kind: str,
             namespace: str | None = None,
             label_selector: Mapping[str, str] | None = None) -> list[dict]:
        with self._lock:
            storage_av = self._storage_av(api_version, kind)
            out = []
            for (av, k, ns, _), obj in self._store.items():
                if av != storage_av or k != kind:
                    continue
                if namespace and ns != namespace:
                    continue
                if match_labels(obj, label_selector):
                    out.append(self._registry.convert(
                        copy.deepcopy(obj), api_version))
            out.sort(key=lambda o: (o["metadata"].get("namespace", ""),
                                    o["metadata"]["name"]))
            return out

    def _update(self, obj: dict, subresource: str | None) -> dict:
        obj = copy.deepcopy(obj)
        m = obj["metadata"]
        requested_av = obj["apiVersion"]
        with self._lock:
            key = self._key(requested_av, obj["kind"], m.get("namespace"),
                            m["name"])
            obj = self._registry.convert(obj, key[0])
            m = obj["metadata"]
            existing = self._store.get(key)
            if existing is None:
                raise ApiError.not_found(
                    f"{obj['kind']} {m.get('namespace', '')}/{m['name']}"
                    " not found")
            sent_rv = m.get("resourceVersion")
            if (sent_rv is not None
                    and sent_rv != existing["metadata"]["resourceVersion"]):
                raise ApiError.conflict(
                    f"{obj['kind']} {m['name']}: resourceVersion {sent_rv} "
                    "is stale")
            if subresource == "status":
                new = copy.deepcopy(existing)
                new["status"] = copy.deepcopy(obj.get("status", {}))
            else:
                new = obj
                # status is a subresource: a plain update cannot change it
                if "status" in existing:
                    new["status"] = copy.deepcopy(existing["status"])
                else:
                    new.pop("status", None)
            for immutable in ("uid", "creationTimestamp"):
                new["metadata"][immutable] = existing["metadata"][immutable]
            new["metadata"]["resourceVersion"] = self._next_rv()
            self._store[key] = new
            if new["kind"] == "CustomResourceDefinition":
                self._registry.register_crd(new)
            return self._registry.convert(copy.deepcopy(new), requested_av)

    def update(self, obj: dict) -> dict:
        return self._update(obj, subresource=None)

    def update_status(self, obj: dict) -> dict:
        return self._update(obj, subresource="status")

    def patch(self, api_version: str, kind: str, name: str, patch: dict,
              namespace: str | None = None) -> dict:
        """JAX's fake's merge patch: applied to the latest object (any
        resourceVersion in the patch is dropped); a patch naming
        ``status`` writes it through the status subresource."""
        with self._lock:
            current = self.get(api_version, kind, name, namespace)
            patched = merge_patch(current, patch)
            patched["metadata"]["resourceVersion"] = (
                current["metadata"]["resourceVersion"])
            if "status" in patch:
                with_status = self._update(patched, subresource="status")
                if set(patch.keys()) - {"status"}:
                    patched["metadata"]["resourceVersion"] = (
                        with_status["metadata"]["resourceVersion"])
                    return self._update(patched, subresource=None)
                return with_status
            return self._update(patched, subresource=None)

    def delete(self, api_version: str, kind: str, name: str,
               namespace: str | None = None) -> None:
        with self._lock:
            key = self._key(api_version, kind, namespace, name)
            obj = self._store.pop(key, None)
            if obj is None:
                raise ApiError.not_found(
                    f"{kind} {namespace or ''}/{name} not found")
            self._cascade_delete(obj)
            if kind == "Namespace":
                for k in [k for k, o in self._store.items()
                          if o["metadata"].get("namespace") == name]:
                    self._store.pop(k, None)

    def _cascade_delete(self, owner: dict) -> None:
        owner_uid = owner["metadata"]["uid"]
        owner_ns = owner["metadata"].get("namespace", "")
        doomed = []
        for key, obj in self._store.items():
            # A namespaced owner cascades within its own namespace only.
            child_ns = obj["metadata"].get("namespace", "")
            if owner_ns and child_ns != owner_ns:
                continue
            for ref in obj["metadata"].get("ownerReferences", []):
                if ref.get("uid") == owner_uid or (
                    not ref.get("uid")
                    and ref.get("kind") == owner["kind"]
                    and ref.get("name") == owner["metadata"]["name"]
                ):
                    doomed.append(key)
                    break
        for key in doomed:
            obj = self._store.pop(key, None)
            if obj is not None:
                self._cascade_delete(obj)

    def ensure_namespace(self, name: str) -> None:
        if self.get_or_none("v1", "Namespace", name) is None:
            self.create({"apiVersion": "v1", "kind": "Namespace",
                         "metadata": {"name": name}})


_PATH_RE = re.compile(
    r"^(?:/api/(?P<core_version>[^/]+)|/apis/(?P<group>[^/]+)/(?P<version>[^/]+))"
    r"(?:/namespaces/(?P<namespace>[^/]+))?"
    r"/(?P<plural>[^/]+)"
    r"(?:/(?P<name>[^/]+))?"
    r"(?:/(?P<subresource>status))?$"
)


def _status_body(code: int, reason: str, message: str) -> dict:
    return {"kind": "Status", "apiVersion": "v1", "code": code,
            "reason": reason, "message": message}


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    fake: FakeApiServer  # bound by serve()

    def log_message(self, *args):
        pass

    def _send_json(self, code: int, payload: dict) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _read_body(self) -> dict:
        length = int(self.headers.get("Content-Length", 0))
        return json.loads(self.rfile.read(length) or b"{}")

    def _route(self):
        """(api_version, kind, namespace, name, subresource, query)."""
        url = urlparse(self.path)
        m = _PATH_RE.match(url.path)
        if not m:
            raise ApiError(404, "NotFound", f"no route {url.path}")
        g = m.groupdict()
        api_version = (g["core_version"] if g["core_version"]
                       else f"{g['group']}/{g['version']}")
        kind = self.fake._registry.kind_for_plural(g["plural"])
        return (api_version, kind, g["namespace"], g["name"],
                g["subresource"], parse_qs(url.query))

    def _answer(self, act, code: int = 200) -> None:
        try:
            self._send_json(code, act())
        except ApiError as e:
            self._send_json(e.code, _status_body(e.code, e.reason,
                                                 e.message))

    def do_GET(self):
        def act():
            api_version, kind, ns, name, _sub, query = self._route()
            if name:
                return self.fake.get(api_version, kind, name, ns)
            selector = None
            if "labelSelector" in query:
                selector = dict(part.split("=", 1) for part in
                                query["labelSelector"][0].split(","))
            return {"apiVersion": api_version, "kind": f"{kind}List",
                    "items": self.fake.list(api_version, kind, ns,
                                            label_selector=selector)}
        self._answer(act)

    def do_POST(self):
        self._answer(lambda: self.fake.create(self._read_body()), 201)

    def do_PUT(self):
        def act():
            sub = self._route()[4]
            obj = self._read_body()
            return (self.fake.update_status(obj) if sub == "status"
                    else self.fake.update(obj))
        self._answer(act)

    def do_PATCH(self):
        def act():
            api_version, kind, ns, name, _sub, _q = self._route()
            if self.headers.get("Content-Type") not in (
                    "application/merge-patch+json", "application/json"):
                raise ApiError(415, "UnsupportedMediaType",
                               "only merge-patch is supported")
            return self.fake.patch(api_version, kind, name,
                                   self._read_body(), ns)
        self._answer(act)

    def do_DELETE(self):
        def act():
            api_version, kind, ns, name, _sub, _q = self._route()
            self.fake.delete(api_version, kind, name, ns)
            return _status_body(200, "Success", "deleted")
        self._answer(act)


def serve(fake: FakeApiServer, port: int = 0
          ) -> tuple[ThreadingHTTPServer, int]:
    """Serve ``fake`` on 127.0.0.1:<port> in a daemon thread; returns
    (httpd, bound_port). Stop it with ``httpd.shutdown()``."""
    handler = type("BoundHandler", (_Handler,), {"fake": fake})
    httpd = ThreadingHTTPServer(("127.0.0.1", port), handler)
    httpd.daemon_threads = True
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, httpd.server_address[1]
