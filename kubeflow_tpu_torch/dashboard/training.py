"""Training dashboard: ``python -m kubeflow_tpu_torch.dashboard.training``;
a copy of ``kubeflow_tpu/dashboard/training.py`` over the port's modules.

The tf-job-dashboard analogue: jobs across all six kinds with replica
status, conditions, and published metrics.

- ``GET /api/jobs``                      all jobs (all kinds)
- ``GET /api/namespaces/<ns>/jobs``      jobs in one namespace
- ``GET /``                              HTML table
- ``GET /healthz``
"""

from __future__ import annotations

import argparse
import html
import re
import sys
from http.server import ThreadingHTTPServer

from kubeflow_tpu_torch.apis import ALL_JOB_KINDS, JOBS_API_VERSION
from kubeflow_tpu_torch.k8s_client import ApiError, K8sClient
from kubeflow_tpu_torch.runtime import (
    add_client_args,
    client_from_args,
    strip_glog_args,
)
from kubeflow_tpu_torch.webapps import JsonHandler

_RE_NS = re.compile(r"^/api/namespaces/([^/]+)/jobs/?$")

_PAGE = """<!doctype html>
<html><head><title>training jobs</title>
<style>body{{font-family:sans-serif;margin:2rem}}table{{border-collapse:collapse}}
td,th{{border:1px solid #ccc;padding:4px 10px}}</style></head>
<body><h1>Training jobs</h1>
<table><tr><th>Kind</th><th>Name</th><th>Namespace</th><th>State</th>
<th>Replicas</th><th>Metrics</th></tr>{rows}</table></body></html>
"""


class TrainingDashboard:
    def __init__(self, client: K8sClient):
        self.client = client

    def jobs(self, namespace: str | None = None) -> list[dict]:
        out = []
        for kind in ALL_JOB_KINDS:
            try:
                items = self.client.list(JOBS_API_VERSION, kind, namespace)
            except ApiError:
                continue
            for job in items:
                status = job.get("status", {})
                out.append({
                    "kind": kind,
                    "name": job["metadata"]["name"],
                    "namespace": job["metadata"]["namespace"],
                    "state": status.get("state", "Unknown"),
                    "replicaStatuses": status.get("replicaStatuses", {}),
                    "conditions": status.get("conditions", []),
                    "metrics": status.get("metrics", {}),
                    "restartCount": status.get("restartCount", 0),
                })
        return out

    def render_html(self) -> str:
        rows = "".join(
            "<tr>"
            f"<td>{html.escape(j['kind'])}</td>"
            f"<td>{html.escape(j['name'])}</td>"
            f"<td>{html.escape(j['namespace'])}</td>"
            f"<td>{html.escape(j['state'])}</td>"
            f"<td>{html.escape(str(j['replicaStatuses']))}</td>"
            f"<td>{html.escape(str(j['metrics']))}</td>"
            "</tr>"
            for j in self.jobs()
        )
        return _PAGE.format(rows=rows)


def make_server(dash: TrainingDashboard, port: int) -> ThreadingHTTPServer:
    class Handler(JsonHandler):
        def do_GET(self):
            if self.path in ("/healthz", "/readyz"):
                self.send_json(200, {"status": "ok"})
                return
            if self.path == "/api/jobs":
                self.send_json(200, {"jobs": dash.jobs()})
                return
            m = _RE_NS.match(self.path)
            if m:
                self.send_json(200, {"jobs": dash.jobs(m.group(1))})
                return
            if self.path in ("/", "/index.html"):
                self.send_html(200, dash.render_html())
                return
            self.send_json(404, {"error": f"no route {self.path}"})

    return ThreadingHTTPServer(("0.0.0.0", port), Handler)


def main(argv=None) -> int:
    argv = strip_glog_args(list(sys.argv[1:] if argv is None else argv))
    p = argparse.ArgumentParser(description="training-job dashboard")
    add_client_args(p)
    p.add_argument("--port", type=int, default=8085)
    args = p.parse_args(argv)

    httpd = make_server(TrainingDashboard(client_from_args(args)), args.port)
    print(f"training dashboard on :{args.port}")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
