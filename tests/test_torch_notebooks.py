"""GPU notebooks over the port against the JAX package's notebooks.

- The Notebook CRD is JAX's, byte for byte.
- The port's NotebookController and JAX's, on the same CRs and pods
  (each on its own package's fake apiserver), write the same
  StatefulSet, Service and status after the mapping: ``google.com/tpu``
  limits become ``nvidia.com/gpu``, the TPU accelerator selector
  ``cloud.google.com/gke-tpu-accelerator`` becomes
  ``cloud.google.com/gke-accelerator``, and JAX's default notebook image
  the port's.
- The jupyter web app's routes give the same codes and bodies, and the
  CRs they create are equal under the same mapping (``tpuChips`` stays on
  the wire and counts GPUs).
- Nothing of JAX's needs a GPU counterpart where it does not count
  ``google.com/tpu``: its admission webhook adds nothing to an
  ``nvidia.com/gpu`` pod but what it adds to a CPU pod (the credentials
  mount), and its profile controller lands a ``requests.nvidia.com/gpu``
  quota whole.
"""

import copy
import http.client
import json
import threading

import pytest

from kubeflow_tpu.apis import notebooks as jnb_api
from kubeflow_tpu.apis.profiles import profile, profile_crd
from kubeflow_tpu.auth.webhook import mutate_pod
from kubeflow_tpu.k8s.fake import FakeApiServer as JFake
from kubeflow_tpu.manifests import images as jimages
from kubeflow_tpu.operators.notebooks import (
    NotebookController as JNotebookController,
)
from kubeflow_tpu.operators.profiles import ProfileController
from kubeflow_tpu.webapps import jupyter as jjupyter
from kubeflow_tpu_torch.apis import notebooks as tnb_api
from kubeflow_tpu_torch.k8s_fake import FakeApiServer as TFake
from kubeflow_tpu_torch.manifests import images
from kubeflow_tpu_torch.operators.notebooks import (
    LABEL_NOTEBOOK,
    NotebookController,
)
from kubeflow_tpu_torch.webapps import jupyter as tjupyter

TPU = "google.com/tpu"
TPU_SELECTOR = "cloud.google.com/gke-tpu-accelerator"
GPU_SELECTOR = "cloud.google.com/gke-accelerator"
NS = "kubeflow"


def to_gpu(obj):
    """JAX's object under the mapping."""
    text = json.dumps(obj)
    text = text.replace(TPU, images.GPU_RESOURCE)
    text = text.replace(TPU_SELECTOR, GPU_SELECTOR)
    text = text.replace(jimages.NOTEBOOK, images.NOTEBOOK)
    return json.loads(text)


def strip(obj: dict) -> dict:
    """An object without the fields each fake assigns."""
    obj = copy.deepcopy(obj)
    meta = obj.get("metadata", {})
    for key in ("uid", "resourceVersion", "creationTimestamp", "generation"):
        meta.pop(key, None)
    for ref in meta.get("ownerReferences", []):
        ref.pop("uid", None)
    return obj


def test_crd_equals_jax():
    assert tnb_api.notebook_crd() == jnb_api.notebook_crd()


@pytest.mark.parametrize("kw", [
    {}, {"tpu_chips": 2}, {"tpu_chips": 1, "workspace_pvc": "ws",
                           "cpu": "4", "memory": "16Gi"}])
def test_notebook_builder_equals_jax_under_the_mapping(kw):
    want = to_gpu(jnb_api.notebook("nb", NS, "img", **kw))
    assert tnb_api.notebook("nb", NS, "img", **kw) == want


def _crs(nb_api):
    """The same CRs, each built by its package's builder (what each web
    app POSTs)."""
    custom = nb_api.notebook("custom", NS, "my/image:1", tpu_chips=2)
    empty = {"apiVersion": jnb_api.NOTEBOOKS_API_VERSION,
             "kind": "Notebook", "metadata": {"name": "empty",
                                              "namespace": NS},
             "spec": {"tpu": {"chips": 1, "accelerator": "POOL"}}}
    suspended = copy.deepcopy(empty)
    suspended["metadata"]["name"] = "parked"
    suspended["spec"]["suspend"] = True
    cpu = nb_api.notebook("cpu", NS, "my/image:1")
    return [custom, empty, suspended, cpu]


def _pods():
    def pod(name, nb, phase, state=None):
        p = {"apiVersion": "v1", "kind": "Pod",
             "metadata": {"name": name, "namespace": NS,
                          "labels": {LABEL_NOTEBOOK: nb}},
             "spec": {"containers": [{"name": "notebook", "image": "x"}]},
             "status": {"phase": phase}}
        if state:
            p["status"]["containerStatuses"] = [{"state": state}]
        return p
    return [pod("custom-0", "custom", "Running",
                {"running": {"startedAt": "2026-01-01T00:00:00Z"}}),
            pod("empty-0", "empty", "Pending",
                {"waiting": {"reason": "ContainerCreating"}})]


def _run(fake, ctrl_cls, nb_api, accel: str):
    fake.ensure_namespace(NS)
    fake.apply(nb_api.notebook_crd())
    for cr in _crs(nb_api):
        cr = json.loads(json.dumps(cr).replace("POOL", accel))
        fake.create(cr)
    ctrl = ctrl_cls(fake)
    ctrl.reconcile_all()
    for p in _pods():
        status = p.pop("status")
        created = fake.create(p)
        created["status"] = status
        fake.update_status(created)
    ctrl.reconcile_all()
    out = {}
    for kind, av in (("StatefulSet", "apps/v1"), ("Service", "v1"),
                     ("Notebook", jnb_api.NOTEBOOKS_API_VERSION)):
        out[kind] = [strip(o) for o in fake.list(av, kind, NS)]
    return out


def test_controller_objects_and_status_equal_jax_under_the_mapping():
    want = to_gpu(_run(JFake(), JNotebookController, jnb_api,
                       "tpu-v5-lite-podslice"))
    got = _run(TFake(), NotebookController, tnb_api, "tpu-v5-lite-podslice")
    assert got == want
    sts = {s["metadata"]["name"]: s for s in got["StatefulSet"]}
    spec = sts["empty"]["spec"]["template"]["spec"]
    (c,) = spec["containers"]
    assert c["image"] == images.NOTEBOOK
    assert c["resources"]["limits"] == {images.GPU_RESOURCE: 1}
    assert spec["nodeSelector"] == {GPU_SELECTOR: "tpu-v5-lite-podslice"}
    assert sts["parked"]["spec"]["replicas"] == 0
    status = {n["metadata"]["name"]: n.get("status") for n in got["Notebook"]}
    assert status["custom"]["readyReplicas"] == 1
    assert status["empty"]["readyReplicas"] == 0
    assert "waiting" in status["empty"]["containerState"]


def test_controller_puts_a_gpu_notebook_on_the_gpu_pool():
    fake = TFake()
    fake.ensure_namespace(NS)
    fake.apply(tnb_api.notebook_crd())
    fake.create(tnb_api.notebook("g", NS, images.NOTEBOOK, tpu_chips=1)
                | {"spec": {"tpu": {"chips": 1,
                                    "accelerator": "nvidia-h100-80gb"}}})
    NotebookController(fake).reconcile_all()
    sts = fake.get("apps/v1", "StatefulSet", "g", NS)
    spec = sts["spec"]["template"]["spec"]
    assert spec["nodeSelector"] == {GPU_SELECTOR: "nvidia-h100-80gb"}
    assert spec["containers"][0]["resources"]["limits"] == {
        images.GPU_RESOURCE: 1}
    assert TPU not in json.dumps(sts)


class _App:
    def __init__(self, mod, fake):
        fake.ensure_namespace(NS)
        fake.apply(jnb_api.notebook_crd())
        self.fake = fake
        self.httpd = mod.make_server(mod.JupyterApp(fake, "default/img:1"), 0)
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()

    def call(self, method, path, body=None):
        conn = http.client.HTTPConnection(
            "127.0.0.1", self.httpd.server_address[1], timeout=10)
        try:
            conn.request(method, path,
                         body=None if body is None else json.dumps(body),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            raw = resp.read().decode()
        finally:
            conn.close()
        if resp.getheader("Content-Type", "").startswith("text/html"):
            return resp.status, "html"
        return resp.status, json.loads(raw)


ROUTES = [
    ("GET", "/healthz", None),
    ("GET", f"/api/namespaces/{NS}/notebooks", None),
    ("POST", f"/api/namespaces/{NS}/notebooks",
     {"name": "a", "tpuChips": 1}),
    ("POST", f"/api/namespaces/{NS}/notebooks",
     {"name": "b", "image": "my/img:2", "cpu": 2, "memory": "8Gi",
      "workspace": {"size": "10Gi", "storageClass": "fast"}}),
    ("POST", f"/api/namespaces/{NS}/notebooks", {"name": "Bad_Name"}),
    ("POST", f"/api/namespaces/{NS}/notebooks", {"name": "a"}),
    ("GET", f"/api/namespaces/{NS}/notebooks", None),
    ("DELETE", f"/api/namespaces/{NS}/notebooks/b", None),
    ("DELETE", f"/api/namespaces/{NS}/notebooks/zz", None),
    ("GET", f"/api/namespaces/{NS}/notebooks", None),
    ("GET", "/", None),
    ("GET", "/nowhere", None),
    ("POST", "/nowhere", {}),
]


def test_web_app_routes_equal_jax():
    apps = {"jax": _App(jjupyter, JFake()), "torch": _App(tjupyter, TFake())}
    try:
        answers = {k: [] for k in apps}
        for method, path, body in ROUTES:
            for k, app in apps.items():
                code, out = app.call(method, path, body)
                if isinstance(out, dict) and "error" in out:
                    out = {"error": "<message>"}  # each package's wording
                answers[k].append((method, path, code, out))
        assert answers["torch"] == answers["jax"]
        codes = [a[2] for a in answers["torch"]]
        assert codes == [200, 200, 201, 201, 400, 409, 200, 200, 404, 200,
                         200, 404, 404]
        made = {}
        for k, app in apps.items():
            made[k] = [strip(o) for o in app.fake.list(
                jnb_api.NOTEBOOKS_API_VERSION, "Notebook", NS)] + [
                strip(o) for o in app.fake.list(
                    "v1", "PersistentVolumeClaim", NS)]
        assert made["torch"] == to_gpu(made["jax"])
        (a,) = [o for o in made["torch"] if o["metadata"]["name"] == "a"]
        (c,) = a["spec"]["template"]["spec"]["containers"]
        assert c["resources"]["limits"] == {images.GPU_RESOURCE: 1}
        page = apps["torch"].httpd
        assert "GPUs" in tjupyter._SHELL and page is not None
    finally:
        for app in apps.values():
            app.httpd.shutdown()


def _pod(limits: dict | None, cred: bool) -> dict:
    c = {"name": "main", "image": "img"}
    if limits:
        c["resources"] = {"limits": limits}
    labels = {"kubeflow-tpu.org/cred-secret": "sa-key"} if cred else {}
    return {"apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": "p", "namespace": NS, "labels": labels},
            "spec": {"containers": [c]}}


@pytest.mark.parametrize("cred", [False, True])
def test_jax_webhook_treats_a_gpu_pod_as_a_cpu_pod(cred):
    gpu = mutate_pod(_pod({images.GPU_RESOURCE: 1}, cred))
    cpu = mutate_pod(_pod(None, cred))
    tpu = mutate_pod(_pod({TPU: 4}, cred))
    assert gpu == cpu
    assert not any("TPU" in json.dumps(p) or "JAX" in json.dumps(p)
                   for p in gpu)
    assert (gpu == []) == (not cred)
    assert len(tpu) > len(gpu)  # the TPU env defaults, for TPU pods only


def test_jax_profile_controller_lands_a_gpu_quota_whole(api):
    quota = {"hard": {"requests.nvidia.com/gpu": "8",
                      "limits.nvidia.com/gpu": "8", "requests.cpu": "64"}}
    api.apply(profile_crd())
    api.create(profile("team-gpu", "alice@example.com", quota=quota))
    ProfileController(api).reconcile_all()
    got = api.get("v1", "ResourceQuota", "profile-quota", "team-gpu")
    assert got["spec"] == quota
