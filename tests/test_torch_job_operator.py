"""The port's job controller against JAX's, kind by kind.

Each case runs one sequence twice: on JAX's fake apiserver under JAX's
``JobController`` and on the port's ``k8s_fake`` under the port's, with
one injected clock. Pod phases are written directly, as the envtest tier
of ``tests/test_operators.py`` writes them (the port has no kubelet
simulator; this file moves the pods instead). After every pass the
jobs' statuses must be equal and the pods equal under the mapping:
JAX's TPU selector ``cloud.google.com/gke-tpu-accelerator: <pool>``
(and its topology)
becomes the GPU selector ``cloud.google.com/gke-accelerator: <pool>``,
the pool ``v5e`` becomes ``nvidia-h100-80gb``, and the env loses its
``TPU_*`` keys.
"""

from __future__ import annotations

import datetime
import json

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from kubeflow_tpu.apis import jobs as jjobs_api  # noqa: E402
from kubeflow_tpu.apis import scheduling as jsched_api  # noqa: E402
from kubeflow_tpu.k8s.fake import FakeApiServer as JFake  # noqa: E402
from kubeflow_tpu.operators import jobs as jjobs  # noqa: E402
from kubeflow_tpu_torch.apis import jobs as tjobs_api  # noqa: E402
from kubeflow_tpu_torch.apis import scheduling as tsched_api  # noqa: E402
from kubeflow_tpu_torch.k8s_fake import FakeApiServer as TFake  # noqa: E402
from kubeflow_tpu_torch.manifests import generate, images  # noqa: E402
from kubeflow_tpu_torch.operators import jobs as tjobs  # noqa: E402

NS = "kubeflow"
JAX_TOPO_SELECTOR = "cloud.google.com/gke-tpu-topology"


def to_gpu(obj):
    text = json.dumps(obj)
    text = text.replace(jsched_api.NODE_ACCEL_LABEL,
                        tsched_api.NODE_ACCEL_LABEL)
    return json.loads(text.replace("v5e", "nvidia-h100-80gb"))


@pytest.fixture()
def clock(monkeypatch):
    now = datetime.datetime(2026, 1, 1, tzinfo=datetime.timezone.utc)
    stamp = now.isoformat().replace("+00:00", "Z")
    for mod in (jjobs, tjobs):
        monkeypatch.setattr(mod, "_now", lambda: stamp)


def make_job(kind="JaxJob", name="train", replicas=4, **spec_extra):
    """``tests/test_operators.py``'s job."""
    replica_types = {
        "JaxJob": {"Worker": replicas},
        "TFJob": {"Chief": 1, "PS": 2, "Worker": replicas},
        "PyTorchJob": {"Master": 1, "Worker": replicas},
        "MXNetJob": {"Scheduler": 1, "Server": 1, "Worker": replicas},
        "ChainerJob": {"Master": 1, "Worker": replicas},
        "MPIJob": {"Launcher": 1, "Worker": replicas},
    }[kind]
    return {
        "apiVersion": jjobs_api.JOBS_API_VERSION,
        "kind": kind,
        "metadata": {"name": name, "namespace": NS},
        "spec": {
            "replicaSpecs": {
                rt: {"replicas": n, "restartPolicy": "OnFailure",
                     "template": {"spec": {"containers": [
                         {"name": "main", "image": "train:latest"}]}}}
                for rt, n in replica_types.items()},
            **spec_extra,
        },
    }


class Pair:
    """One job kind's controller in each package, on its own fake."""

    def __init__(self, kind: str):
        self.kind = kind
        self.j, self.t = JFake(), TFake()
        for api in (self.j, self.t):
            api.ensure_namespace(NS)
        for crd in jjobs_api.all_job_crds():
            self.j.apply(crd)
        for crd in tjobs_api.all_job_crds():
            self.t.apply(crd)
        self.jc = jjobs.JobController(self.j, kind)
        self.tc = tjobs.JobController(self.t, kind)

    def create(self, job: dict) -> None:
        self.j.create(job)
        self.t.create(to_gpu(job))

    def reconcile(self) -> None:
        assert self.jc.reconcile_all() == self.tc.reconcile_all()
        self.check()

    def pod_status(self, pod_name: str, status: dict) -> None:
        for api in (self.j, self.t):
            pod = api.get("v1", "Pod", pod_name, NS)
            pod["status"] = status
            api.update_status(pod)

    def annotate_pod(self, pod_name: str, ann: dict) -> None:
        for api in (self.j, self.t):
            pod = api.get("v1", "Pod", pod_name, NS)
            pod["metadata"].setdefault("annotations", {}).update(ann)
            api.update(pod)

    def annotate_job(self, name: str, ann: dict) -> None:
        for api, value in ((self.j, ann), (self.t, to_gpu(ann))):
            job = api.get(jjobs_api.JOBS_API_VERSION, self.kind, name, NS)
            job["metadata"].setdefault("annotations", {}).update(value)
            api.update(job)

    def check(self) -> None:
        jjobs_ = self.j.list(jjobs_api.JOBS_API_VERSION, self.kind, NS)
        tjobs_ = self.t.list(jjobs_api.JOBS_API_VERSION, self.kind, NS)
        assert [o.get("status") for o in tjobs_] == \
            [to_gpu(o).get("status") for o in jjobs_]
        assert [project_pod(p) for p in self.t.list("v1", "Pod", NS)] == \
            [project_pod(to_gpu(p)) for p in self.j.list("v1", "Pod", NS)]
        assert [project_svc(s) for s in self.t.list("v1", "Service", NS)] \
            == [project_svc(s) for s in self.j.list("v1", "Service", NS)]

    def job(self, name: str = "train") -> dict:
        return self.t.get(jjobs_api.JOBS_API_VERSION, self.kind, name, NS)

    def env(self, pod_name: str) -> dict:
        pod = self.t.get("v1", "Pod", pod_name, NS)
        return {e["name"]: e["value"]
                for e in pod["spec"]["containers"][0]["env"]}


def project_pod(pod: dict) -> dict:
    out = {k: pod[k] for k in ("apiVersion", "kind", "spec")}
    out["spec"] = dict(out["spec"])
    sel = dict(out["spec"].get("nodeSelector") or {})
    sel.pop(JAX_TOPO_SELECTOR, None)
    if sel or "nodeSelector" in out["spec"]:
        out["spec"]["nodeSelector"] = sel
    out["spec"]["containers"] = [
        {**c, "env": [e for e in c.get("env", [])
                      if not e["name"].startswith("TPU_")]}
        for c in out["spec"]["containers"]]
    meta = pod["metadata"]
    out["metadata"] = {k: meta.get(k) for k in ("name", "namespace",
                                                "labels", "annotations")}
    out["owner"] = [(r["kind"], r["name"])
                    for r in meta.get("ownerReferences", [])]
    out["status"] = pod.get("status")
    return out


def project_svc(svc: dict) -> dict:
    return {"name": svc["metadata"]["name"],
            "labels": svc["metadata"].get("labels"), "spec": svc["spec"]}


# ---------------------------------------------------------------------------
# tests/test_operators.py's job cases, each run by both controllers
# ---------------------------------------------------------------------------


def case_creates_gang_and_env(p: Pair):
    p.create(make_job(tpu={"accelerator": "v5e", "topology": "2x4"}))
    p.reconcile()
    env = p.env("train-worker-0")
    assert env["JAX_COORDINATOR_ADDRESS"] == \
        "train-worker-0.train.kubeflow:8476"
    assert (env["JAX_NUM_PROCESSES"], env["JAX_PROCESS_ID"]) == ("4", "0")
    assert not [k for k in env if k.startswith("TPU_")]
    pod = p.t.get("v1", "Pod", "train-worker-0", NS)
    assert pod["spec"]["nodeSelector"] == {
        "cloud.google.com/gke-accelerator": "nvidia-h100-80gb"}


def case_running_then_succeeded_cleans_pods(p: Pair):
    p.create(make_job(replicas=2))
    p.reconcile()
    for i in range(2):
        p.pod_status(f"train-worker-{i}", {"phase": "Running"})
    p.reconcile()
    assert p.job()["status"]["state"] == "Running"
    for i in range(2):
        p.pod_status(f"train-worker-{i}", {"phase": "Succeeded"})
    p.reconcile()
    assert p.job()["status"]["state"] == "Succeeded"


def _exit(phase: str, code: int) -> dict:
    return {"phase": phase, "containerStatuses": [
        {"name": "main", "state": {"terminated": {"exitCode": code}}}]}


def case_restart_on_failure_and_backoff(p: Pair):
    p.create(make_job(replicas=2, runPolicy={"backoffLimit": 1}))
    p.reconcile()
    p.pod_status("train-worker-0", {"phase": "Failed"})
    p.reconcile()
    assert p.job()["status"]["restartCount"] == 1
    p.pod_status("train-worker-0", {"phase": "Failed"})
    p.reconcile()
    assert p.job()["status"]["state"] == "Failed"


def case_never_restart_fails_job(p: Pair):
    job = make_job(replicas=2)
    job["spec"]["replicaSpecs"]["Worker"]["restartPolicy"] = "Never"
    p.create(job)
    p.reconcile()
    p.pod_status("train-worker-1", {"phase": "Failed"})
    p.reconcile()
    assert p.job()["status"]["state"] == "Failed"


def case_exitcode_policy(p: Pair):
    job = make_job(replicas=2)
    job["spec"]["replicaSpecs"]["Worker"]["restartPolicy"] = "ExitCode"
    p.create(job)
    p.reconcile()
    p.pod_status("train-worker-0", _exit("Failed", 137))
    p.reconcile()
    assert p.job()["status"]["state"] == "Restarting"
    p.pod_status("train-worker-1", _exit("Failed", 1))
    p.reconcile()
    assert p.job()["status"]["state"] == "Failed"


def case_declined_gang_restart_does_not_churn(p: Pair):
    job = make_job(replicas=2, runPolicy={"backoffLimit": 0})
    job["spec"]["replicaSpecs"]["Worker"]["restartPolicy"] = "ExitCode"
    p.create(job)
    p.reconcile()
    p.pod_status("train-worker-0", _exit("Failed", 1))
    p.pod_status("train-worker-1", _exit("Failed", 137))
    p.reconcile()
    assert p.job()["status"].get("restartCount", 0) == 0


def case_invalid_spec_fails(p: Pair):
    bad = make_job()
    bad["spec"]["replicaSpecs"]["Worker"]["template"] = {"spec": {}}
    p.create(bad)
    p.reconcile()
    assert any(c["reason"] == "InvalidSpec"
               for c in p.job()["status"]["conditions"])


def case_multislice_env(p: Pair):
    p.create(make_job(replicas=4, tpu={"accelerator": "v5e",
                                       "numSlices": 2}))
    p.reconcile()
    env = p.env("train-worker-3")
    assert (env["MEGASCALE_NUM_SLICES"], env["MEGASCALE_SLICE_ID"]) == \
        ("2", "1")


def case_gang_restart_restarts_all_workers(p: Pair):
    p.create(make_job(replicas=3))
    p.reconcile()
    for i in range(3):
        p.pod_status(f"train-worker-{i}", {"phase": "Running"})
    p.reconcile()
    p.pod_status("train-worker-1", {"phase": "Failed"})
    p.reconcile()
    p.reconcile()
    assert p.job()["status"]["restartCount"] == 1


def case_preemption_reschedules_without_burning_backoff(p: Pair):
    job = make_job(replicas=2, runPolicy={"backoffLimit": 0})
    job["spec"]["replicaSpecs"]["Worker"]["restartPolicy"] = "Never"
    p.create(job)
    p.reconcile()
    p.pod_status("train-worker-0", {"phase": "Failed", "reason": "Preempted",
                                    **_exit("Failed", 137)})
    p.reconcile()
    p.reconcile()
    assert p.job()["status"]["preemptionCount"] == 1


def case_preemption_by_disruption_target(p: Pair):
    p.create(make_job(replicas=2, runPolicy={"backoffLimit": 0}))
    p.reconcile()
    p.pod_status("train-worker-0", {"phase": "Failed", "conditions": [
        {"type": "DisruptionTarget", "status": "True",
         "reason": "EvictionByEvictionAPI"}]})
    p.reconcile()
    p.reconcile()
    assert p.job()["status"]["preemptionCount"] == 1


def case_preemption_by_scheduler_annotation(p: Pair):
    p.create(make_job(replicas=2, runPolicy={"backoffLimit": 0}))
    p.reconcile()
    p.annotate_pod("train-worker-0",
                   {jsched_api.ANN_PREEMPTED_BY: "JaxJob/kubeflow/vip"})
    p.pod_status("train-worker-0", {"phase": "Failed"})
    p.reconcile()
    p.reconcile()
    assert p.job()["status"]["preemptionCount"] == 1


def case_unknown_phase_counts_as_gang_failure(p: Pair):
    p.create(make_job(replicas=2))
    p.reconcile()
    p.pod_status("train-worker-0", {"phase": "Unknown", "conditions": [
        {"type": "DisruptionTarget", "status": "True"}]})
    p.reconcile()
    p.reconcile()
    assert p.job()["status"]["preemptionCount"] == 1


def case_managed_job_waits_for_its_placement(p: Pair):
    """A managed gang gets no pod until a placement names a host for each;
    then each pod is pinned to its host with the GPU selector."""
    p.create(make_job(replicas=2, priority=5))
    p.reconcile()
    assert p.t.list("v1", "Pod", NS) == []
    p.annotate_job("train", {jsched_api.ANN_PLACEMENT: json.dumps({
        "pool": "v5e", "topology": "", "slice": "s0",
        "nodes": ["n0", "n1"], "decidedAt": "2026-01-01T00:00:00Z"})})
    p.reconcile()
    for i in range(2):
        pod = p.t.get("v1", "Pod", f"train-worker-{i}", NS)
        assert pod["spec"]["nodeName"] == f"n{i}"
        assert pod["spec"]["nodeSelector"] == {
            "cloud.google.com/gke-accelerator": "nvidia-h100-80gb"}
        assert pod["metadata"]["annotations"][tsched_api.ANN_POOL] == \
            "nvidia-h100-80gb"


def case_elastic_grant_above_the_pod_count(p: Pair):
    """An elastic grant larger than the gang seats the pods on its
    prefix; a grant too small parks the gang."""
    p.create(make_job(replicas=1, priority=1,
                      elastic={"minReplicas": 1, "maxReplicas": 3}))
    p.annotate_job("train", {jsched_api.ANN_PLACEMENT: json.dumps({
        "pool": "v5e", "topology": "", "slice": "s0",
        "nodes": ["n0", "n1", "n2"], "decidedAt": "2026-01-01T00:00:00Z",
        "elastic": {"granted": 3, "min": 1, "max": 3}})})
    p.reconcile()
    (pod,) = p.t.list("v1", "Pod", NS)
    assert pod["spec"]["nodeName"] == "n0"


def case_clean_pod_policy_all_and_ttl(p: Pair):
    p.create(make_job(replicas=2, runPolicy={"cleanPodPolicy": "All",
                                             "ttlSecondsAfterFinished": 0}))
    p.reconcile()
    for i in range(2):
        p.pod_status(f"train-worker-{i}", {"phase": "Succeeded"})
    p.reconcile()
    assert p.t.list("v1", "Pod", NS) == []
    p.reconcile()  # the TTL lapsed: the job is deleted
    assert p.t.list(jjobs_api.JOBS_API_VERSION, "JaxJob", NS) == []


def case_tfjob_tf_config(p: Pair):
    p.create(make_job("TFJob", replicas=2))
    p.reconcile()
    tf_config = json.loads(p.env("train-worker-1")["TF_CONFIG"])
    assert tf_config["task"] == {"type": "worker", "index": 1}
    p.pod_status("train-chief-0", {"phase": "Succeeded"})
    p.reconcile()
    assert p.job()["status"]["state"] == "Succeeded"


def case_pytorchjob_master_env(p: Pair):
    p.create(make_job("PyTorchJob", replicas=3))
    p.reconcile()
    env = p.env("train-worker-2")
    assert (env["MASTER_ADDR"], env["WORLD_SIZE"], env["RANK"]) == \
        ("train-master-0.train.kubeflow", "4", "3")


def case_mxnetjob_env(p: Pair):
    p.create(make_job("MXNetJob", replicas=2))
    p.reconcile()
    assert p.env("train-worker-1")["DMLC_WORKER_ID"] == "1"


def case_chainerjob_env(p: Pair):
    p.create(make_job("ChainerJob", replicas=2))
    p.reconcile()
    assert p.env("train-worker-1")["CHAINERMN_PROCESS_ID"] == "2"


def case_mpijob_hostfile(p: Pair):
    p.create(make_job("MPIJob", replicas=2))
    p.reconcile()
    assert "train-worker-0.train.kubeflow slots=1" in \
        p.env("train-launcher-0")["MPI_HOSTFILE_CONTENT"]


def case_gpu_prototype_job(p: Pair):
    """A job rendered by ``gpu-job-simple``: its pods ask for
    ``nvidia.com/gpu`` and carry the rendezvous env the port reads."""
    (job,) = generate("gpu-job-simple", {"name": "train", "num_workers": 2})
    p.create(job)
    p.reconcile()
    pod = p.t.get("v1", "Pod", "train-worker-1", NS)
    assert pod["spec"]["containers"][0]["resources"]["limits"] == \
        {images.GPU_RESOURCE: 1}
    assert p.env("train-worker-1")["JAX_PROCESS_ID"] == "1"


CASES = {
    "JaxJob": [case_creates_gang_and_env,
               case_running_then_succeeded_cleans_pods,
               case_restart_on_failure_and_backoff,
               case_never_restart_fails_job, case_exitcode_policy,
               case_declined_gang_restart_does_not_churn,
               case_invalid_spec_fails, case_multislice_env,
               case_gang_restart_restarts_all_workers,
               case_preemption_reschedules_without_burning_backoff,
               case_preemption_by_disruption_target,
               case_preemption_by_scheduler_annotation,
               case_unknown_phase_counts_as_gang_failure,
               case_managed_job_waits_for_its_placement,
               case_elastic_grant_above_the_pod_count,
               case_clean_pod_policy_all_and_ttl, case_gpu_prototype_job],
    "TFJob": [case_tfjob_tf_config],
    "PyTorchJob": [case_pytorchjob_master_env],
    "MXNetJob": [case_mxnetjob_env],
    "ChainerJob": [case_chainerjob_env],
    "MPIJob": [case_mpijob_hostfile],
}
PARAMS = [(kind, fn) for kind, fns in CASES.items() for fn in fns]


@pytest.mark.parametrize("kind,case", PARAMS,
                         ids=[f"{k}-{f.__name__[5:]}" for k, f in PARAMS])
def test_job_controller_equals_jax(kind, case, clock):
    case(Pair(kind))


def test_job_api_equals_jax():
    """The CRDs, the validation and the names the controllers share."""
    assert tjobs_api.all_job_crds() == jjobs_api.all_job_crds()
    assert tjobs_api.REPLICA_TYPES == jjobs_api.REPLICA_TYPES
    good = make_job(replicas=1, priority=1,
                    elastic={"minReplicas": 1, "maxReplicas": 4})
    tjobs_api.validate_job(good)
    for bad in (make_job(replicas=2, priority=1,
                         elastic={"minReplicas": 1, "maxReplicas": 4}),
                make_job(elastic={"minReplicas": "many"}),
                make_job(runPolicy={"cleanPodPolicy": "Sometimes"}),
                make_job(kind="TFJob") | {"kind": "XJob"}):
        with pytest.raises(jjobs_api.JobValidationError) as want:
            jjobs_api.validate_job(bad)
        with pytest.raises(tjobs_api.JobValidationError) as got:
            tjobs_api.validate_job(bad)
        assert str(got.value) == str(want.value)
