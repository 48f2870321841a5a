"""Jupyter web app for GPU notebooks: ``python -m
kubeflow_tpu_torch.webapps.jupyter``; a copy of
``kubeflow_tpu/webapps/jupyter.py``.

JAX's routes and wire format: the ``tpuChips`` field stays on the wire
(the CR's ``spec.tpu`` block keeps JAX's schema) and counts GPUs, which
:func:`kubeflow_tpu_torch.apis.notebooks.notebook` turns into
``nvidia.com/gpu`` limits. Standard library only.

- ``GET    /api/namespaces/<ns>/notebooks``       list
- ``POST   /api/namespaces/<ns>/notebooks``       create (+ optional PVC)
- ``DELETE /api/namespaces/<ns>/notebooks/<name>`` delete
- ``GET    /``                                     HTML shell
- ``GET    /healthz``
"""

from __future__ import annotations

import argparse
import re
import sys
from http.server import ThreadingHTTPServer

from kubeflow_tpu_torch.apis.notebooks import (
    NOTEBOOK_KIND,
    NOTEBOOKS_API_VERSION,
    notebook,
)
from kubeflow_tpu_torch.k8s_client import ApiError, K8sClient
from kubeflow_tpu_torch.manifests import objects as k8s
from kubeflow_tpu_torch.runtime import (
    add_client_args,
    client_from_args,
    strip_glog_args,
)
from kubeflow_tpu_torch.webapps import JsonHandler

_RE_LIST = re.compile(r"^/api/namespaces/([^/]+)/notebooks/?$")
_RE_ITEM = re.compile(r"^/api/namespaces/([^/]+)/notebooks/([^/]+)$")

_SHELL = """<!doctype html>
<html><head><title>kubeflow-tpu notebooks</title></head>
<body><h2>Notebooks</h2>
<p>JSON API: GET/POST /api/namespaces/&lt;ns&gt;/notebooks,
DELETE /api/namespaces/&lt;ns&gt;/notebooks/&lt;name&gt;</p>
<p>GPUs: a notebook's <code>tpuChips</code> field counts the
nvidia.com/gpu devices it asks for.</p>
</body></html>
"""


class JupyterApp:
    def __init__(self, client: K8sClient, default_image: str):
        self.client = client
        self.default_image = default_image

    # -- operations ------------------------------------------------------

    def list_notebooks(self, namespace: str) -> list[dict]:
        items = self.client.list(NOTEBOOKS_API_VERSION, NOTEBOOK_KIND,
                                 namespace)
        return [
            {
                "name": nb["metadata"]["name"],
                "namespace": nb["metadata"]["namespace"],
                "image": self._image_of(nb),
                "tpuChips": nb["spec"].get("tpu", {}).get("chips", 0),
                "state": nb.get("status", {}).get("state", "Unknown"),
                "url": f"/notebook/{namespace}/{nb['metadata']['name']}/",
            }
            for nb in items
        ]

    @staticmethod
    def _image_of(nb: dict) -> str:
        containers = (
            nb["spec"].get("template", {}).get("spec", {})
            .get("containers", [])
        )
        return containers[0].get("image", "") if containers else ""

    def create_notebook(self, namespace: str, body: dict) -> dict:
        name = body.get("name")
        if not name or not re.fullmatch(r"[a-z0-9]([-a-z0-9]*[a-z0-9])?",
                                        name):
            raise ValueError("invalid notebook name")
        workspace_pvc = None
        ws = body.get("workspace") or {}
        if ws.get("size"):
            workspace_pvc = f"{name}-workspace"
            self.client.apply(k8s.pvc(
                workspace_pvc, namespace, ws["size"],
                storage_class=ws.get("storageClass"),
            ))
        nb = notebook(
            name,
            namespace,
            image=body.get("image") or self.default_image,
            tpu_chips=int(body.get("tpuChips", 0)),
            cpu=str(body.get("cpu", "1")),
            memory=str(body.get("memory", "2Gi")),
            workspace_pvc=workspace_pvc,
        )
        return self.client.create(nb)

    def delete_notebook(self, namespace: str, name: str) -> None:
        self.client.delete(NOTEBOOKS_API_VERSION, NOTEBOOK_KIND, name,
                           namespace)


def make_server(app: JupyterApp, port: int) -> ThreadingHTTPServer:
    class Handler(JsonHandler):
        def do_GET(self):
            if self.path in ("/healthz", "/readyz"):
                self.send_json(200, {"status": "ok"})
                return
            m = _RE_LIST.match(self.path)
            if m:
                try:
                    self.send_json(
                        200, {"notebooks": app.list_notebooks(m.group(1))}
                    )
                except ApiError as e:
                    self.send_json(e.code, {"error": str(e)})
                return
            if self.path == "/":
                self.send_html(200, _SHELL)
                return
            self.send_json(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            m = _RE_LIST.match(self.path)
            if not m:
                self.send_json(404, {"error": f"no route {self.path}"})
                return
            try:
                created = app.create_notebook(m.group(1), self.read_json())
                self.send_json(201, {"name": created["metadata"]["name"]})
            except ValueError as e:
                self.send_json(400, {"error": str(e)})
            except ApiError as e:
                self.send_json(e.code, {"error": str(e)})

        def do_DELETE(self):
            m = _RE_ITEM.match(self.path)
            if not m:
                self.send_json(404, {"error": f"no route {self.path}"})
                return
            try:
                app.delete_notebook(m.group(1), m.group(2))
                self.send_json(200, {"deleted": m.group(2)})
            except ApiError as e:
                self.send_json(e.code, {"error": str(e)})

    return ThreadingHTTPServer(("0.0.0.0", port), Handler)


def main(argv=None) -> int:
    argv = strip_glog_args(list(sys.argv[1:] if argv is None else argv))
    p = argparse.ArgumentParser(description="jupyter web app (GPU notebooks)")
    add_client_args(p)
    p.add_argument("--port", type=int, default=5000)
    p.add_argument("--default-image", required=True)
    args = p.parse_args(argv)

    app = JupyterApp(client_from_args(args), args.default_image)
    httpd = make_server(app, args.port)
    print(f"jupyter web app on :{args.port}")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
