"""Central dashboard: platform overview UI + JSON API; a copy of
``kubeflow_tpu/dashboard/__init__.py`` over the port's modules.

It aggregates component links (Services carrying gateway-route
annotations, read by the port gateway's ``routes_from_service``),
training jobs, notebooks, studies and workflow runs into one landing
page, with a namespace selector, the ``/embed/<component>`` view and an
activity feed harvested from object conditions, served as
query-filtered HTML + JSON.
"""

from __future__ import annotations

import html
from http.server import ThreadingHTTPServer
from urllib.parse import parse_qs, quote, unquote, urlsplit

from kubeflow_tpu_torch.apis import ALL_JOB_KINDS, JOBS_API_VERSION
from kubeflow_tpu_torch.apis.notebooks import (
    NOTEBOOK_KIND,
    NOTEBOOKS_API_VERSION,
)
from kubeflow_tpu_torch.apis.pipelines import (
    PIPELINES_API_VERSION,
    WORKFLOW_KIND,
)
from kubeflow_tpu_torch.apis.tuning import STUDY_JOB_KIND, TUNING_API_VERSION
from kubeflow_tpu_torch.gateway import routes_from_service
from kubeflow_tpu_torch.k8s_client import ApiError, K8sClient
from kubeflow_tpu_torch.operators.runstore import RunStore
from kubeflow_tpu_torch.webapps import JsonHandler

_EMBED_PAGE = """<!doctype html>
<html><head><title>{name} — kubeflow-tpu</title>
<style>body{{margin:0;font-family:sans-serif}}
nav{{padding:6px 12px;background:#f4f4f4;border-bottom:1px solid #ccc}}
iframe{{border:0;width:100vw;height:calc(100vh - 40px)}}</style></head>
<body><nav><a href="/">kubeflow-tpu</a> / {name}</nav>
<iframe src="{src}" title="{name}"></iframe>
</body></html>
"""

_PAGE = """<!doctype html>
<html><head><title>kubeflow-tpu</title>
<style>body{{font-family:sans-serif;margin:2rem}}table{{border-collapse:collapse}}
td,th{{border:1px solid #ccc;padding:4px 10px}}</style></head>
<body><h1>kubeflow-tpu</h1>
<form method="get" action="/">Namespace:
<select name="namespace" onchange="this.form.submit()">{ns_options}</select>
<noscript><button type="submit">Go</button></noscript></form>
<h2>Components</h2><ul>{components}</ul>
<h2>Jobs</h2><table><tr><th>Kind</th><th>Name</th><th>Namespace</th>
<th>State</th></tr>{jobs}</table>
<h2>Notebooks</h2><table><tr><th>Name</th><th>Namespace</th><th>State</th>
</tr>{notebooks}</table>
<h2>Studies</h2><table><tr><th>Name</th><th>Namespace</th><th>State</th>
<th>Best</th></tr>{studies}</table>
<h2>Pipeline runs</h2><table><tr><th>Workflow</th><th>Schedule</th>
<th>Phase</th><th>Started</th><th>Finished</th><th>Artifacts</th></tr>
{runs}</table>
<h2>Activity</h2><table><tr><th>Time</th><th>Kind</th><th>Object</th>
<th>Event</th><th>Message</th></tr>{activity}</table>
</body></html>
"""


class Dashboard:
    def __init__(self, client: K8sClient, namespace: str | None = None):
        self.client = client
        self.namespace = namespace

    def _safe_list(self, api_version: str, kind: str,
                   namespace: str | None = None) -> list[dict]:
        try:
            return self.client.list(api_version, kind,
                                    namespace or self.namespace)
        except ApiError:
            return []

    def namespaces(self) -> list[str]:
        """Names for the namespace selector (reference:
        namespace-selector.js fed by /api/namespaces)."""
        try:
            return sorted(ns["metadata"]["name"]
                          for ns in self.client.list("v1", "Namespace"))
        except ApiError:
            return []

    def components(self, namespace: str | None = None) -> list[dict]:
        out = []
        for svc in self._safe_list("v1", "Service", namespace):
            for route in routes_from_service(svc):
                out.append({"name": route.name, "prefix": route.prefix,
                            "service": route.service})
        return out

    def _raw_jobs(self, namespace: str | None = None
                  ) -> list[tuple[str, dict]]:
        return [
            (kind, job)
            for kind in ALL_JOB_KINDS
            for job in self._safe_list(JOBS_API_VERSION, kind, namespace)
        ]

    def jobs(self, namespace: str | None = None,
             raw: list[tuple[str, dict]] | None = None) -> list[dict]:
        return [{
            "kind": kind,
            "name": job["metadata"]["name"],
            "namespace": job["metadata"]["namespace"],
            "state": job.get("status", {}).get("state", "Unknown"),
        } for kind, job in (raw if raw is not None
                            else self._raw_jobs(namespace))]

    def notebooks(self, namespace: str | None = None) -> list[dict]:
        return [{
            "name": nb["metadata"]["name"],
            "namespace": nb["metadata"]["namespace"],
            "state": nb.get("status", {}).get("state", "Unknown"),
        } for nb in self._safe_list(NOTEBOOKS_API_VERSION, NOTEBOOK_KIND,
                                    namespace)]

    def studies(self, namespace: str | None = None) -> list[dict]:
        return [{
            "name": s["metadata"]["name"],
            "namespace": s["metadata"]["namespace"],
            "state": s.get("status", {}).get("state", "Unknown"),
            "bestObjective": s.get("status", {}).get("bestObjective"),
        } for s in self._safe_list(TUNING_API_VERSION, STUDY_JOB_KIND,
                                   namespace)]

    def runs(self, namespace: str | None = None) -> list[dict]:
        """Workflow run history — outlives the Workflow CRs (RunStore,
        the pipeline-persistenceagent surface)."""
        try:
            return RunStore(self.client).list_runs(
                namespace or self.namespace)
        except ApiError:
            return []

    def activity(self, namespace: str | None = None, limit: int = 50,
                 raw_jobs: list[tuple[str, dict]] | None = None
                 ) -> list[dict]:
        """Recent state transitions harvested from object conditions —
        the dashboard-view.js activity feed, without a separate event
        store: every controller already timestamps its condition flips.
        ``raw_jobs`` lets overview() share one apiserver sweep between the
        job table and the feed."""
        events = []
        if raw_jobs is None:
            raw_jobs = self._raw_jobs(namespace)
        for kind, job in raw_jobs:
            m = job["metadata"]
            for cond in job.get("status", {}).get("conditions", []):
                if cond.get("status") != "True":
                    continue
                events.append({
                    "time": cond.get("lastTransitionTime", ""),
                    "kind": kind,
                    "name": m["name"],
                    "namespace": m["namespace"],
                    "event": cond.get("type", ""),
                    "message": cond.get("message", ""),
                })
        for wf in self._safe_list(PIPELINES_API_VERSION, WORKFLOW_KIND,
                                  namespace):
            m = wf["metadata"]
            status = wf.get("status", {})
            if status.get("phase"):
                events.append({
                    "time": status.get("finishedAt")
                    or status.get("startedAt", ""),
                    "kind": WORKFLOW_KIND,
                    "name": m["name"],
                    "namespace": m["namespace"],
                    "event": status["phase"],
                    "message": status.get("message", ""),
                })
        events.sort(key=lambda e: e["time"], reverse=True)
        return events[:limit]

    def overview(self, namespace: str | None = None) -> dict:
        raw_jobs = self._raw_jobs(namespace)
        return {
            "namespaces": self.namespaces(),
            "components": self.components(namespace),
            "jobs": self.jobs(raw=raw_jobs),
            "notebooks": self.notebooks(namespace),
            "studies": self.studies(namespace),
            "runs": self.runs(namespace),
            "activity": self.activity(namespace, raw_jobs=raw_jobs),
        }

    @staticmethod
    def _embeddable(prefix: str) -> bool:
        """Only same-origin path-shaped prefixes may become an
        auto-loading iframe src: the annotation is namespace-user-
        controlled, and a javascript: URI or protocol-relative
        //host (or \\-tricked) URL would load attacker content in the
        dashboard chrome on page load (html.escape cannot prevent it)."""
        return (prefix.startswith("/")
                and not prefix.startswith("//")
                and not prefix.startswith("/\\"))

    def render_embed(self, component: str) -> str | None:
        """In-place component view (centraldashboard's iframe-container
        pattern, public/components/iframe-container.js): the web app
        renders inside the dashboard chrome, reached through the gateway
        at its annotated prefix."""
        for c in self.components():
            if c["name"] == component and self._embeddable(c["prefix"]):
                return _EMBED_PAGE.format(name=html.escape(component),
                                          src=html.escape(c["prefix"]))
        return None

    def render_html(self, namespace: str | None = None) -> str:
        ov = self.overview(namespace)

        def esc(v) -> str:
            return html.escape(str(v))

        ns_options = "<option value=\"\">all namespaces</option>" + "".join(
            f"<option value=\"{esc(ns)}\""
            f"{' selected' if ns == namespace else ''}>{esc(ns)}</option>"
            for ns in ov["namespaces"]
        )
        def component_link(c) -> str:
            # Non-embeddable prefixes link straight to the component —
            # an /embed link would just 404 on the _embeddable guard.
            if not self._embeddable(c["prefix"]):
                return (f"<li><a href=\"{esc(c['prefix'])}\">"
                        f"{esc(c['name'])}</a> → {esc(c['service'])}</li>")
            return (f"<li><a href=\"/embed/{esc(quote(c['name'], safe=''))}"
                    f"\">{esc(c['name'])}</a> → {esc(c['service'])} "
                    f"(<a href=\"{esc(c['prefix'])}\">direct</a>)</li>")

        components = "".join(
            component_link(c) for c in ov["components"]
        ) or "<li>(none)</li>"
        jobs = "".join(
            f"<tr><td>{esc(j['kind'])}</td><td>{esc(j['name'])}</td>"
            f"<td>{esc(j['namespace'])}</td><td>{esc(j['state'])}</td></tr>"
            for j in ov["jobs"]
        )
        notebooks = "".join(
            f"<tr><td>{esc(n['name'])}</td><td>{esc(n['namespace'])}</td>"
            f"<td>{esc(n['state'])}</td></tr>" for n in ov["notebooks"]
        )
        studies = "".join(
            f"<tr><td>{esc(s['name'])}</td><td>{esc(s['namespace'])}</td>"
            f"<td>{esc(s['state'])}</td><td>{esc(s['bestObjective'])}</td>"
            "</tr>" for s in ov["studies"]
        )
        def _arts(r):
            return "; ".join(a["uri"] for a in r.get("artifacts", [])) \
                or "—"

        runs = "".join(
            f"<tr><td>{esc(r['workflow'])}</td>"
            f"<td>{esc(r.get('scheduledWorkflow', ''))}</td>"
            f"<td>{esc(r['phase'])}</td><td>{esc(r.get('startedAt', ''))}"
            f"</td><td>{esc(r.get('finishedAt', ''))}</td>"
            f"<td>{esc(_arts(r))}</td></tr>"
            for r in ov["runs"]
        )
        activity = "".join(
            f"<tr><td>{esc(e['time'])}</td><td>{esc(e['kind'])}</td>"
            f"<td>{esc(e['namespace'])}/{esc(e['name'])}</td>"
            f"<td>{esc(e['event'])}</td><td>{esc(e['message'])}</td></tr>"
            for e in ov["activity"]
        )
        return _PAGE.format(ns_options=ns_options, components=components,
                            jobs=jobs, notebooks=notebooks, studies=studies,
                            runs=runs, activity=activity)


def make_server(dash: Dashboard, port: int) -> ThreadingHTTPServer:
    class Handler(JsonHandler):
        def do_GET(self):
            url = urlsplit(self.path)
            ns = parse_qs(url.query).get("namespace", [None])[0] or None
            if url.path in ("/healthz", "/readyz"):
                self.send_json(200, {"status": "ok"})
            elif url.path == "/api/overview":
                self.send_json(200, dash.overview(ns))
            elif url.path == "/api/runs":
                self.send_json(200, {"runs": dash.runs(ns)})
            elif url.path == "/api/activity":
                self.send_json(200, {"activity": dash.activity(ns)})
            elif url.path == "/api/namespaces":
                self.send_json(200, {"namespaces": dash.namespaces()})
            elif url.path.startswith("/embed/"):
                page = dash.render_embed(unquote(url.path[len("/embed/"):]))
                if page is None:
                    self.send_json(404, {"error": "unknown component"})
                else:
                    self.send_html(200, page)
            elif url.path in ("/", "/index.html"):
                self.send_html(200, dash.render_html(ns))
            else:
                self.send_json(404, {"error": f"no route {url.path}"})

    return ThreadingHTTPServer(("0.0.0.0", port), Handler)
