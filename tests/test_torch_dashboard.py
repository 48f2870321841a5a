"""The port's dashboards (``kubeflow_tpu_torch/dashboard/``) against the
JAX package's, over the same cluster.

Each case builds the same objects (job, notebook, study and workflow
CRDs and CRs, component Services with gateway-route annotations, run
records) into JAX's fake apiserver and into the port's, serves both
dashboards over real sockets and holds every JSON answer and every HTML
page equal, beside what ``tests/test_webapps.py`` asserts of JAX's. The
run records come from each package's ``RunStore``; the entry points
``python -m kubeflow_tpu_torch.dashboard`` and ``.dashboard.training``
start against an apiserver over HTTP with JAX's flags.
"""

import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path
from types import SimpleNamespace

import pytest

from kubeflow_tpu.apis import jobs as jobs_api
from kubeflow_tpu.apis.notebooks import notebook_crd
from kubeflow_tpu.apis.pipelines import PIPELINES_API_VERSION, workflow_crd
from kubeflow_tpu.apis.tuning import TUNING_API_VERSION, study_job_crd
from kubeflow_tpu.dashboard import Dashboard as JaxDashboard
from kubeflow_tpu.dashboard import make_server as jax_make_dash
from kubeflow_tpu.dashboard.training import (
    TrainingDashboard as JaxTrainingDashboard,
    make_server as jax_make_training,
)
from kubeflow_tpu.k8s import FakeApiServer as JaxFake
from kubeflow_tpu.manifests.core import GATEWAY_ROUTE_ANNOTATION
from kubeflow_tpu.operators.runstore import RunStore as JaxRunStore
from kubeflow_tpu_torch.dashboard import Dashboard, make_server
from kubeflow_tpu_torch.dashboard.training import (
    TrainingDashboard,
    make_server as make_training,
)
from kubeflow_tpu_torch.k8s_fake import FakeApiServer as TorchFake
from kubeflow_tpu_torch.operators.runstore import RunStore

ROOT = Path(__file__).resolve().parent.parent
SIDES = {
    "jax": (JaxFake, JaxDashboard, jax_make_dash, JaxTrainingDashboard,
            jax_make_training, JaxRunStore),
    "torch": (TorchFake, Dashboard, make_server, TrainingDashboard,
              make_training, RunStore),
}


def _route_svc(name, spec: str) -> dict:
    return {"apiVersion": "v1", "kind": "Service",
            "metadata": {"name": name, "namespace": "kubeflow",
                         "annotations": {GATEWAY_ROUTE_ANNOTATION: spec}},
            "spec": {"ports": [{"port": 80}]}}


def _job(name, ns, status):
    return {"apiVersion": jobs_api.JOBS_API_VERSION, "kind": "JaxJob",
            "metadata": {"name": name, "namespace": ns},
            "spec": {"replicaSpecs": {}}, "status": status}


WORKFLOW = {
    "apiVersion": PIPELINES_API_VERSION, "kind": "Workflow",
    "metadata": {"name": "nightly", "namespace": "default",
                 "labels": {"kubeflow-tpu.org/scheduled-workflow": "cron"}},
    "spec": {"tasks": [{"name": "t", "resource": {
        "apiVersion": "v1", "kind": "ConfigMap"}}]},
    "status": {"phase": "Succeeded", "startedAt": "2026-07-30T10:06:00Z",
               "finishedAt": "2026-07-30T10:07:00Z",
               "tasks": {"t": {"artifacts": [
                   {"name": "model", "uri": "gs://b/model"}]}}},
}


def build_cluster(side: str):
    """The same cluster in one package's fake: CRDs, two jobs in two
    namespaces (one with condition flips and metrics), a notebook, a
    study, a workflow with its run record, and two component Services."""
    fake_cls, *_rest, store_cls = SIDES[side]
    api = fake_cls()
    for ns in ("kubeflow", "default"):
        api.ensure_namespace(ns)
    for crd in (*jobs_api.all_job_crds(), notebook_crd(), study_job_crd(),
                workflow_crd()):
        api.apply(crd)
    api.create(_job("train1", "kubeflow", {"state": "Running"}))
    api.create(_job("other-train", "default", {
        "state": "Succeeded",
        "replicaStatuses": {"Worker": {"succeeded": 2}},
        "metrics": {"loss": 0.25},
        "conditions": [
            {"type": "Created", "status": "True", "reason": "",
             "message": "gang created",
             "lastTransitionTime": "2026-07-30T10:00:00Z"},
            {"type": "Running", "status": "False", "reason": "",
             "message": "", "lastTransitionTime": "2026-07-30T10:01:00Z"},
            {"type": "Succeeded", "status": "True", "reason": "",
             "message": "all workers finished",
             "lastTransitionTime": "2026-07-30T10:05:00Z"}]}))
    api.create({"apiVersion": "kubeflow-tpu.org/v1", "kind": "Notebook",
                "metadata": {"name": "nb1", "namespace": "kubeflow"},
                "spec": {}, "status": {"state": "Ready"}})
    api.create({"apiVersion": TUNING_API_VERSION, "kind": "StudyJob",
                "metadata": {"name": "sweep", "namespace": "default"},
                "spec": {}, "status": {"state": "Completed",
                                       "bestObjective": 0.125}})
    api.create(json.loads(json.dumps(WORKFLOW)))
    store_cls(api).record(json.loads(json.dumps(WORKFLOW)))
    api.create(_route_svc("jupyter-web-app",
                          "{name: jupyter, prefix: /jupyter/, "
                          "service: 'jupyter-web-app.kubeflow:80'}"))
    api.create(_route_svc("evil", "{name: evil app, prefix: "
                                  "'javascript:alert(1)', "
                                  "service: 'evil.kubeflow:80'}"))
    return api


def serve(httpd):
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{httpd.server_address[1]}"


def get(base, path):
    try:
        with urllib.request.urlopen(base + path) as r:
            body, ctype, code = r.read(), r.headers.get(
                "Content-Type", ""), r.status
    except urllib.error.HTTPError as e:
        body, ctype, code = e.read(), e.headers.get("Content-Type", ""), \
            e.code
    return code, ctype, (json.loads(body) if "json" in ctype
                         else body.decode())


@pytest.fixture(scope="module")
def dashboards():
    """Both central dashboards and both training dashboards, each over
    its package's copy of the cluster."""
    out, stops = {}, []
    for side, (_f, dash_cls, make, train_cls, make_train, _s) in \
            SIDES.items():
        api = build_cluster(side)
        central, training = make(dash_cls(api), 0), make_train(
            train_cls(api), 0)
        out[side] = {"api": api, "central": serve(central),
                     "training": serve(training)}
        stops += [central.shutdown, training.shutdown]
    yield out
    for stop in stops:
        stop()


CENTRAL_PATHS = [
    "/", "/index.html", "/?namespace=default", "/?namespace=kubeflow",
    "/healthz", "/readyz", "/api/overview", "/api/overview?namespace=default",
    "/api/runs", "/api/runs?namespace=kubeflow", "/api/activity",
    "/api/activity?namespace=default", "/api/namespaces",
    "/embed/jupyter", "/embed/evil%20app", "/embed/nope", "/no/such",
]


@pytest.mark.parametrize("path", CENTRAL_PATHS)
def test_central_dashboard_answers_as_jax(dashboards, path):
    got = get(dashboards["torch"]["central"], path)
    assert got == get(dashboards["jax"]["central"], path)
    assert got[0] in (200, 404)


def test_central_dashboard_overview_and_activity(dashboards):
    """``test_webapps``' overview, namespace filter and activity feed,
    read from the port's dashboard."""
    base = dashboards["torch"]["central"]
    _, _, ov = get(base, "/api/overview")
    assert {j["name"] for j in ov["jobs"]} == {"train1", "other-train"}
    assert {"kubeflow", "default"} <= set(ov["namespaces"])
    assert [n["name"] for n in ov["notebooks"]] == ["nb1"]
    assert ov["studies"][0]["bestObjective"] == 0.125
    assert ov["runs"][0]["artifacts"] == [
        {"name": "model", "uri": "gs://b/model"}]
    _, _, ov = get(base, "/api/overview?namespace=default")
    assert [j["name"] for j in ov["jobs"]] == ["other-train"]
    _, _, page = get(base, "/?namespace=default")
    assert "other-train" in page and "train1" not in page
    assert "<h1>kubeflow-tpu</h1>" in page
    _, _, act = get(base, "/api/activity?namespace=default")
    events = act["activity"]
    assert [e["event"] for e in events[:3]] == [
        "Succeeded", "Succeeded", "Created"]
    assert events[0]["kind"] == "Workflow"
    assert events[1]["message"] == "all workers finished"


def test_embed_view_and_hostile_prefixes(dashboards):
    """``test_webapps``' embed case on both packages: the component
    renders in an iframe at its gateway prefix; a ``javascript:`` or
    protocol-relative prefix never becomes an iframe src nor an embed
    link, and a path-shaped one does again."""
    pages = {}
    for side in ("jax", "torch"):
        api, base = dashboards[side]["api"], dashboards[side]["central"]
        seen = [get(base, "/embed/jupyter"), get(base, "/embed/evil%20app"),
                "/embed/evil%20app" in get(base, "/")[2]]
        for prefix in ("'//evil.example/'", "/ok/"):
            live = api.get("v1", "Service", "evil", "kubeflow")
            live["metadata"]["annotations"][GATEWAY_ROUTE_ANNOTATION] = (
                f"{{name: evil app, prefix: {prefix}, "
                "service: 'evil.kubeflow:80'}")
            api.update(live)
            seen += [get(base, "/embed/evil%20app"),
                     "/embed/evil%20app" in get(base, "/")[2]]
        pages[side] = seen
    assert pages["torch"] == pages["jax"]
    seen = pages["torch"]
    assert seen[0][0] == 200 and '<iframe src="/jupyter/"' in seen[0][2]
    assert seen[1][0] == 404 and seen[2] is False
    assert seen[3][0] == 404 and seen[4] is False
    assert seen[5][0] == 200 and '<iframe src="/ok/"' in seen[5][2]
    assert seen[6] is True


@pytest.mark.parametrize("path", ["/", "/index.html", "/healthz",
                                  "/api/jobs",
                                  "/api/namespaces/default/jobs",
                                  "/api/namespaces/kubeflow/jobs/",
                                  "/api/nothing"])
def test_training_dashboard_answers_as_jax(dashboards, path):
    got = get(dashboards["torch"]["training"], path)
    assert got == get(dashboards["jax"]["training"], path)


def test_training_dashboard_lists_every_kind(dashboards):
    _, _, out = get(dashboards["torch"]["training"], "/api/jobs")
    jobs = {j["name"]: j for j in out["jobs"]}
    assert set(jobs) == {"train1", "other-train"}
    assert jobs["other-train"]["metrics"] == {"loss": 0.25}
    assert jobs["other-train"]["replicaStatuses"] == {
        "Worker": {"succeeded": 2}}


@pytest.mark.parametrize("side", ["jax", "torch"])
def test_run_store_records_prunes_and_heals(side):
    """``RunStore`` over each package's fake: a record per run that
    outlives its Workflow, listed newest first, kept per schedule, and a
    lost record healed; both packages' records equal."""
    def run(side):
        fake_cls, *_r, store_cls = SIDES[side]
        api = fake_cls()
        api.ensure_namespace("default")
        store = store_cls(api)
        for i in range(4):
            wf = json.loads(json.dumps(WORKFLOW))
            wf["metadata"]["name"] = f"nightly-{i}"
            wf["status"]["startedAt"] = f"2026-07-30T10:0{i}:00Z"
            store.record(wf)
        adhoc = json.loads(json.dumps(WORKFLOW))
        adhoc["metadata"] = {"name": "oneoff", "namespace": "default"}
        adhoc["status"]["startedAt"] = "2026-07-29T00:00:00Z"
        store.record(adhoc)
        listed = [r["workflow"] for r in store.list_runs("default")]
        pruned = store.prune("default", "cron", 2)
        kept = [r["workflow"] for r in store.list_runs("default", "cron")]
        api.delete("v1", "ConfigMap", "wfrun-oneoff", "default")
        store.ensure_recorded(adhoc)
        healed = [r["workflow"] for r in store.list_runs("default")]
        return listed, pruned, kept, healed, store.prune_adhoc("default", 1)

    got = run(side)
    assert got == run("jax")
    listed, pruned, kept, healed, adhoc_pruned = got
    assert listed[:4] == ["nightly-3", "nightly-2", "nightly-1",
                          "nightly-0"]
    assert pruned == 2 and kept == ["nightly-3", "nightly-2"]
    assert "oneoff" in healed and adhoc_pruned == 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("module,extra", [
    ("kubeflow_tpu_torch.dashboard", ["--all-namespaces"]),
    ("kubeflow_tpu_torch.dashboard.training", [])])
def test_entry_points_serve_from_the_apiserver(module, extra):
    """Each entry point, with JAX's flags, against the cluster over HTTP
    (JAX's HTTP fake): its JSON equals JAX's dashboard's through the
    client JAX's entry point builds from the same flags."""
    from kubeflow_tpu.k8s.httpfake import serve as serve_fake
    from kubeflow_tpu.runtime import client_from_args as jax_client_from_args

    fake = build_cluster("jax")
    httpd, api_port = serve_fake(fake)
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": str(ROOT), "http_proxy": "",
           "HTTP_PROXY": ""}
    proc = subprocess.Popen(
        [sys.executable, "-m", module,
         f"--apiserver=http://127.0.0.1:{api_port}", f"--port={port}",
         "--namespace=kubeflow", "--alsologtostderr", "-v=1", *extra],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    path = "/api/overview" if module.endswith("dashboard") else "/api/jobs"
    try:
        deadline, got = time.time() + 30, None
        while time.time() < deadline:
            try:
                got = get(f"http://127.0.0.1:{port}", path)
                break
            except OSError:
                time.sleep(0.2)
        assert got is not None and got[0] == 200
        # JAX's entry point builds this client from the same flags.
        client = jax_client_from_args(SimpleNamespace(
            apiserver=f"http://127.0.0.1:{api_port}", token_path=""))
        if module.endswith("dashboard"):
            want = JaxDashboard(client).overview()
        else:
            want = {"jobs": JaxTrainingDashboard(client).jobs()}
        assert got[2] == json.loads(json.dumps(want))
    finally:
        proc.terminate()
        proc.communicate(timeout=30)
        httpd.shutdown()
