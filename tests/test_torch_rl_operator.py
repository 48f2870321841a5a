"""The port's RLJob controller against JAX's, and the whole placed path on
the CPU.

The cases are those of ``tests/test_rl.py`` for the API and the
controller: the lowering into two scheduler-managed gangs, the status
aggregation, an invalid CR and a spec change, each reconciled by both
controllers on their own fakes with the children held equal under the
mapping (the port's image and modules, ``nvidia.com/gpu`` for
``google.com/tpu``, and a 0-GPU pod's CPU device: ``"device": "cpu"`` in
the learner's config, ``--device=cpu`` on the actor's command).

The last case runs the path a GPU cluster runs, at ``lm-test-tiny`` on
the CPU: ``gpu-rl``'s RLJob on three GPU-labelled nodes of the port's
fake, lowered by the port's RLJob controller, placed by the port's
scheduler, its pods created by the port's job controller; then each
pod's own command runs here (the pod's ports and pod DNS mapped onto
local ones), the learner pushes once to two actor servers over HTTP, its
``publish_metrics`` writes its metrics into its JaxJob's status through
the port's fake served over HTTP (JAX's HTTP frontend,
``KUBEFLOW_TPU_APISERVER`` naming it), and they reach the RLJob's
``weightsVersion``.
"""

from __future__ import annotations

import copy
import json
import os
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from kubeflow_tpu.apis import jobs as jjobs_api  # noqa: E402
from kubeflow_tpu.apis import rl as jrl_api  # noqa: E402
from kubeflow_tpu.k8s.fake import FakeApiServer as JFake  # noqa: E402
from kubeflow_tpu.manifests import images as jimages  # noqa: E402
from kubeflow_tpu.operators import rl as jrl  # noqa: E402
from kubeflow_tpu_torch.apis import jobs as tjobs_api  # noqa: E402
from kubeflow_tpu_torch.apis import rl as trl_api  # noqa: E402
from kubeflow_tpu_torch.apis import scheduling as tsched_api  # noqa: E402
from kubeflow_tpu_torch.k8s_fake import FakeApiServer as TFake  # noqa: E402
from kubeflow_tpu_torch.manifests import generate, images  # noqa: E402
from kubeflow_tpu_torch.manifests import objects as tk8s  # noqa: E402
from kubeflow_tpu_torch.operators import jobs as tjobs  # noqa: E402
from kubeflow_tpu_torch.operators import rl as trl  # noqa: E402
from kubeflow_tpu_torch.scheduler import controller as tctrl  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
NS = "kubeflow"
JOBS = jjobs_api.JOBS_API_VERSION
TPU = jjobs_api.TPU_RESOURCE


def _cr(api_mod, name="podracer", **kw):
    """``tests/test_rl.py``'s CR."""
    kw.setdefault("learner", {"steps": 10, "pushEverySteps": 2})
    kw.setdefault("actors", {"replicas": 2, "minReplicas": 1,
                             "maxReplicas": 4})
    kw.setdefault("rollout", {"promptLen": 8, "maxNewTokens": 16})
    return api_mod.rl_job(name, NS, "lm-test-tiny", **kw)


def child_to_gpu(job: dict) -> dict:
    """A JAX child JaxJob under the mapping."""
    out = copy.deepcopy(job)
    (c,) = out["spec"]["replicaSpecs"]["Worker"]["template"]["spec"][
        "containers"]
    if c["image"] == jimages.PLATFORM:
        c["image"] = images.TORCH_CUDA
    c["command"] = [a.replace("kubeflow_tpu.", "kubeflow_tpu_torch.")
                    for a in c["command"]]
    gpus = (c.get("resources") or {}).get("limits", {}).get(TPU, 0)
    if c.get("resources"):
        c["resources"] = images.gpu_resources(gpus)
    if c["name"] == "learner" and not gpus:
        cfg = json.loads(c["command"][-1])
        c["command"][-1] = json.dumps({**cfg, "device": "cpu"},
                                      sort_keys=True)
    if c["name"] == "actor" and not gpus:
        c["args"] = c["args"] + ["--device=cpu"]
    if c["name"] == "actor":
        # The port's repair: the floor raised to the pod count.
        elastic = out["spec"]["elastic"]
        elastic["minReplicas"] = max(
            elastic["minReplicas"],
            out["spec"]["replicaSpecs"]["Worker"]["replicas"])
    return out


def stable(obj: dict) -> dict:
    out = copy.deepcopy(obj)
    for k in ("uid", "resourceVersion", "creationTimestamp"):
        out["metadata"].pop(k, None)
    for ref in out["metadata"].get("ownerReferences", []):
        ref.pop("uid", None)
    return out


class Pair:
    def __init__(self):
        self.j, self.t = JFake(), TFake()
        for api in (self.j, self.t):
            api.ensure_namespace(NS)
        self.j.apply(jrl_api.rl_job_crd())
        self.j.apply(jjobs_api.job_crd("JaxJob"))
        self.t.apply(trl_api.rl_job_crd())
        self.t.apply(tjobs_api.job_crd("JaxJob"))
        self.jc = jrl.RLJobController(self.j)
        self.tc = trl.RLJobController(self.t)

    def create(self, **kw) -> None:
        self.j.create(_cr(jrl_api, **kw))
        self.t.create(_cr(trl_api, **kw))

    def reconcile(self) -> None:
        assert self.tc.reconcile_all() == self.jc.reconcile_all()
        for jobj, tobj in zip(self.j.list(JOBS, "JaxJob", NS),
                              self.t.list(JOBS, "JaxJob", NS),
                              strict=True):
            assert stable(tobj) == stable(child_to_gpu(jobj))
        assert [stable(o) for o in self.t.list(
            trl_api.RL_API_VERSION, "RLJob", NS)] == [
            stable(o) for o in self.j.list(
                jrl_api.RL_API_VERSION, "RLJob", NS)]

    def edit(self, fn, kind="RLJob", name="podracer", status=False):
        for api in (self.j, self.t):
            obj = api.get(JOBS, kind, name, NS)
            fn(obj)
            (api.update_status if status else api.update)(obj)


def test_rl_api_equals_jax():
    assert trl_api.rl_job_crd() == jrl_api.rl_job_crd()
    assert _cr(trl_api) == _cr(jrl_api)
    bad = [dict(learner={"priority": 0}, actors={"priority": 10}),
           dict(learner={"priority": 5}, actors={"priority": 5}),
           dict(actors={"replicas": 2, "minReplicas": 3,
                        "maxReplicas": 2}),
           dict(actors={"replicas": 9, "minReplicas": 1,
                        "maxReplicas": 4}),
           dict(learner={"pushEverySteps": 0})]
    for kw in bad:
        with pytest.raises(jrl_api.RLJobValidationError) as want:
            jrl_api.validate_rl_job(_cr(jrl_api, **kw))
        with pytest.raises(trl_api.RLJobValidationError) as got:
            trl_api.validate_rl_job(_cr(trl_api, **kw))
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("chips", [0, 1])
def test_lowers_into_two_scheduler_managed_gangs(chips):
    p = Pair()
    p.create(learner={"steps": 10, "pushEverySteps": 2,
                      "tpuChipsPerReplica": chips},
             actors={"replicas": 2, "minReplicas": 1, "maxReplicas": 4,
                     "tpuChipsPerReplica": chips,
                     "engine": {"kv_fused_attention": True}})
    p.reconcile()
    learner = p.t.get(JOBS, "JaxJob", "podracer-learner", NS)
    actors = p.t.get(JOBS, "JaxJob", "podracer-actors", NS)
    assert (learner["spec"]["priority"], learner["spec"]["preemptible"]) \
        == (100, False)
    assert (actors["spec"]["priority"], actors["spec"]["preemptible"]) \
        == (0, True)
    assert actors["spec"]["elastic"] == {"minReplicas": 2,
                                         "maxReplicas": 4}
    (lc,) = learner["spec"]["replicaSpecs"]["Worker"]["template"]["spec"][
        "containers"]
    (ac,) = actors["spec"]["replicaSpecs"]["Worker"]["template"]["spec"][
        "containers"]
    assert lc["command"][:3] == ["python", "-m",
                                 "kubeflow_tpu_torch.train.rl"]
    assert ac["command"] == ["python", "-m", "kubeflow_tpu_torch.serving"]
    assert "--kv-fused-attention" in ac["args"]
    for c in (lc, ac):
        assert c.get("resources") == images.gpu_resources(chips)
    assert ("--device=cpu" in ac["args"]) == (not chips)
    assert (json.loads(lc["command"][-1]).get("device") == "cpu") == \
        (not chips)
    env = {e["name"]: e["value"] for e in lc["env"]}
    assert env[trl.ENV_RL_ACTORS].split(",") == [
        "podracer-actors-worker-0.podracer-actors.kubeflow:8500",
        "podracer-actors-worker-1.podracer-actors.kubeflow:8500"]


def test_actor_gang_is_a_valid_job_where_jax_lowers_an_invalid_one():
    """JAX's lowering of its own default CR (2 actors, minReplicas 1)
    is a JaxJob its job controller refuses; the port's is valid and
    schedules as JAX's would (the scheduler's floor is the pod count
    either way)."""
    p = Pair()
    p.create()
    p.reconcile()
    jactors = p.j.get(JOBS, "JaxJob", "podracer-actors", NS)
    with pytest.raises(jjobs_api.JobValidationError, match="below the"):
        jjobs_api.validate_job(jactors)
    tjobs_api.validate_job(p.t.get(JOBS, "JaxJob", "podracer-actors", NS))


def test_status_aggregates_children():
    p = Pair()
    p.create()
    p.reconcile()

    def running(job):
        job.setdefault("status", {})["state"] = "Running"
        job["status"]["metrics"] = {"weights_version": 7}

    p.edit(running, "JaxJob", "podracer-learner", status=True)
    p.reconcile()
    st = p.t.get(trl_api.RL_API_VERSION, "RLJob", "podracer", NS)["status"]
    assert (st["phase"], st["weightsVersion"]) == ("Running", 7)

    def done(job):
        job["status"]["state"] = "Succeeded"

    p.edit(done, "JaxJob", "podracer-learner", status=True)
    p.reconcile()
    st = p.t.get(trl_api.RL_API_VERSION, "RLJob", "podracer", NS)["status"]
    assert st["phase"] == "Succeeded"


def test_invalid_cr_fails_without_children():
    p = Pair()
    p.create(name="bad", learner={"priority": 0}, actors={"priority": 5})
    p.reconcile()
    st = p.t.get(trl_api.RL_API_VERSION, "RLJob", "bad", NS)["status"]
    assert st["phase"] == "Failed" and "priority" in st["reason"]
    assert p.t.list(JOBS, "JaxJob", NS) == []


def test_spec_change_updates_children():
    p = Pair()
    p.create()
    p.reconcile()

    def grow(cr):
        cr["spec"]["actors"]["replicas"] = 3
        cr["spec"]["actors"]["maxReplicas"] = 6

    for api in (p.j, p.t):
        cr = api.get(trl_api.RL_API_VERSION, "RLJob", "podracer", NS)
        grow(cr)
        api.update(cr)
    p.reconcile()
    actors = p.t.get(JOBS, "JaxJob", "podracer-actors", NS)
    assert actors["spec"]["replicaSpecs"]["Worker"]["replicas"] == 3
    assert actors["spec"]["elastic"]["maxReplicas"] == 6


def test_gpu_rl_equals_rl_job_under_the_mapping():
    from kubeflow_tpu.manifests import generate as jgenerate

    params = {"name": "x", "model": "lm-test-tiny", "actor_replicas": 2,
              "actor_min_replicas": 1, "actor_max_replicas": 2}
    want = jgenerate("rl-job", {**params, "chips_per_replica": 1})
    want[1]["spec"]["image"] = images.TORCH_CUDA
    assert generate("gpu-rl", {**params, "gpus_per_replica": 1}) == want


# ---------------------------------------------------------------------------
# the whole path on the CPU
# ---------------------------------------------------------------------------


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get(port: int, path: str) -> str:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as r:
        return r.read().decode()


def _wait_ready(proc, port: int, timeout: float = 90.0) -> None:
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        assert proc.poll() is None, "the server exited"
        try:
            if json.loads(_get(port, "/readyz"))["ready"]:
                return
        except OSError:
            pass
        time.sleep(0.1)
    raise AssertionError("the server was not ready")


class _Served:
    """The port's fake behind JAX's HTTP frontend, which reads the kind
    of a path from its fake's ``registry`` (the job kinds here)."""

    def __init__(self, api):
        from kubeflow_tpu.k8s.client import KindRegistry

        self._api, self.registry = api, KindRegistry()
        for crd in jjobs_api.all_job_crds():
            self.registry.register_crd(crd)

    def __getattr__(self, name):
        return getattr(self._api, name)


def _pod_env(c: dict, local: dict, apiserver: str) -> dict:
    """A container's env on this host: pod addresses mapped onto local
    ones, the apiserver served here; one thread a process."""
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "KUBEFLOW_TPU_APISERVER": apiserver}
    for e in c.get("env", []):
        value = e["value"]
        if e["name"] == trl.ENV_RL_ACTORS:
            value = ",".join(local[a] for a in value.split(","))
        env[e["name"]] = value
    return env


def test_rljob_placed_and_run_on_the_cpu(tmp_path):
    api = TFake()
    api.ensure_namespace(NS)
    for crd in (trl_api.rl_job_crd(), *tjobs_api.all_job_crds(),
                tsched_api.scheduling_policy_crd()):
        api.apply(crd)
    api.create(tsched_api.scheduling_policy(namespace=NS))
    for i in range(3):
        api.create(tk8s.node(f"gpu-{i}", {
            tsched_api.NODE_ACCEL_LABEL: "nvidia-h100-80gb",
            tsched_api.NODE_SLICE_LABEL: "h100-0"}, gpus=1))
    crd, cr = generate("gpu-rl", {
        "name": "rl", "model": "lm-test-tiny", "learner_steps": 2,
        "push_every_steps": 1, "actor_replicas": 2,
        "actor_min_replicas": 1, "actor_max_replicas": 2,
        "gpus_per_replica": 0})
    api.create(cr)
    rl_ctrl, sched = trl.RLJobController(api), tctrl.SchedulerController(api)
    jc = tjobs.JobController(api, "JaxJob")
    for _ in range(3):
        for ctrl in (rl_ctrl, sched, jc):
            ctrl.reconcile_all()
    learner = api.get(JOBS, "JaxJob", "rl-learner", NS)
    actors = api.get(JOBS, "JaxJob", "rl-actors", NS)
    assert tsched_api.placement(learner)["nodes"] == ["gpu-0"]
    assert tsched_api.placement(actors)["elastic"] == {
        "granted": 2, "min": 2, "max": 2}
    pods = {p["metadata"]["name"]: p for p in api.list("v1", "Pod", NS)}
    assert sorted(pods) == ["rl-actors-worker-0", "rl-actors-worker-1",
                            "rl-learner-worker-0"]
    assert [pods[n]["spec"]["nodeName"] for n in sorted(pods)] == \
        ["gpu-1", "gpu-2", "gpu-0"]
    for pod in pods.values():
        assert pod["spec"]["nodeSelector"] == {
            tsched_api.NODE_ACCEL_LABEL: "nvidia-h100-80gb"}

    from kubeflow_tpu.k8s.httpfake import serve

    httpd, api_port = serve(_Served(api))
    apiserver = f"http://127.0.0.1:{api_port}"
    procs, local = [], {}
    try:
        for i in range(2):
            name = f"rl-actors-worker-{i}"
            (c,) = pods[name]["spec"]["containers"]
            port = free_port()
            args = [f"--rest-port={port}" if a.startswith("--rest-port=")
                    else a for a in c["args"]] + ["--grpc-port=-1"]
            log = open(tmp_path / f"{name}.log", "w")
            proc = subprocess.Popen(
                [sys.executable, *c["command"][1:], *args], cwd=ROOT,
                env=_pod_env(c, local, apiserver), stdout=log,
                stderr=subprocess.STDOUT)
            procs.append((proc, log))
            local[f"{name}.rl-actors.{NS}:8500"] = f"127.0.0.1:{port}"
        for (proc, _), addr in zip(procs, local.values()):
            _wait_ready(proc, int(addr.rsplit(":", 1)[1]))
        (c,) = pods["rl-learner-worker-0"]["spec"]["containers"]
        out = subprocess.run([sys.executable, *c["command"][1:]], cwd=ROOT,
                             env=_pod_env(c, local, apiserver),
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stdout + out.stderr
        (line,) = [ln for ln in out.stdout.splitlines()
                   if ln.startswith("kubeflow-tpu-metrics: ")]
        metrics = json.loads(line.split(": ", 1)[1])
        assert (metrics["pushes"], metrics["weights_version"]) == (1, 1)
        for addr in local.values():
            page = _get(int(addr.rsplit(":", 1)[1]),
                        "/monitoring/prometheus/metrics")
            assert "serving_weights_version 1" in page
    finally:
        for proc, log in procs:
            proc.terminate()
            proc.wait(timeout=30)
            log.close()
        httpd.shutdown()

    # The learner's publish reached its JaxJob's status; then one more
    # reconcile.
    assert "metrics publish failed" not in out.stdout
    learner = api.get(JOBS, "JaxJob", "rl-learner", NS)
    assert learner["status"]["metrics"] == metrics
    rl_ctrl.reconcile_all()
    st = api.get(trl_api.RL_API_VERSION, "RLJob", "rl", NS)["status"]
    assert st["weightsVersion"] == metrics["weights_version"] == 1
