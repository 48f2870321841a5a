"""The port's cluster scheduler against JAX's, round by round.

Each case builds one cluster twice: TPU-labelled Node objects on JAX's
fake apiserver, under JAX's ``SchedulerController`` and ``JobController``,
and GPU-labelled ones on the port's ``k8s_fake``, under the port's. The
pools map ``v5e`` -> ``nvidia-h100-80gb`` and ``v5p`` ->
``nvidia-a100-80gb``; node names and slice labels are the same strings in
both (so every tie breaks alike), and JAX's default throughput book
reaches the port as its policy's ``spec.profiles`` under the mapping.
One injected clock drives both schedulers and both job controllers.
After every scheduling round and every job-controller pass the jobs'
placements (nodes, slice, elastic grant, ``decidedAt``),
``status.scheduling``, conditions and statuses, the pods (eviction marks
and states included) and the policy's status must be equal under the
mapping: the pool renamed, the TPU topology dropped, the ``TPU_*`` env
keys dropped.

The cases are the deterministic ones of ``tests/test_scheduler.py``.
Its chaos soaks (which train, through JAX's kubelet) and its
event-driven case have no counterpart: the port's runtime polls, with no
watch to drive a round. The fault this slice repairs closes the file: a
job-mode trial JaxJob of the port's Experiment controller on a GPU node
is never placed by JAX's scheduler, and the port's places it and creates
its pod.
"""

from __future__ import annotations

import copy
import datetime
import json
import random

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from kubeflow_tpu.apis import jobs as jjobs_api  # noqa: E402
from kubeflow_tpu.apis import scheduling as jsched_api  # noqa: E402
from kubeflow_tpu.k8s import objects as jk8s  # noqa: E402
from kubeflow_tpu.k8s.fake import FakeApiServer as JFake  # noqa: E402
from kubeflow_tpu.operators import jobs as jjobs  # noqa: E402
from kubeflow_tpu.scheduler import capacity as jcapacity  # noqa: E402
from kubeflow_tpu.scheduler import controller as jctrl  # noqa: E402
from kubeflow_tpu.scheduler import queue as jqueue  # noqa: E402
from kubeflow_tpu_torch.apis import jobs as tjobs_api  # noqa: E402
from kubeflow_tpu_torch.apis import scheduling as tsched_api  # noqa: E402
from kubeflow_tpu_torch.k8s_fake import FakeApiServer as TFake  # noqa: E402
from kubeflow_tpu_torch.manifests import images  # noqa: E402
from kubeflow_tpu_torch.manifests import objects as tk8s  # noqa: E402
from kubeflow_tpu_torch.operators import jobs as tjobs  # noqa: E402
from kubeflow_tpu_torch.scheduler import capacity as tcapacity  # noqa: E402
from kubeflow_tpu_torch.scheduler import controller as tctrl  # noqa: E402
from kubeflow_tpu_torch.scheduler import queue as tqueue  # noqa: E402

NS = "kubeflow"
POOLS = {"v5e": "nvidia-h100-80gb", "v5p": "nvidia-a100-80gb"}
JAX_TOPO_SELECTOR = "cloud.google.com/gke-tpu-topology"


def gpu_pool(pool: str) -> str:
    return POOLS.get(pool, pool)


def to_gpu(obj):
    """A JAX-side object under the mapping: TPU accelerator label key and
    pool names renamed. Node and slice names hold no pool name here, so
    a textual rename touches only pools."""
    text = json.dumps(obj)
    text = text.replace(jsched_api.NODE_ACCEL_LABEL,
                        tsched_api.NODE_ACCEL_LABEL)
    for tpu, gpu in POOLS.items():
        text = text.replace(tpu, gpu)
    return json.loads(text)


@pytest.fixture()
def clock(monkeypatch):
    """One clock for both schedulers and both job controllers; each
    scheduling round advances it a second."""
    now = [datetime.datetime(2026, 1, 1, tzinfo=datetime.timezone.utc)]

    def now_dt():
        return now[0]

    def now_iso():
        return now[0].replace(microsecond=0).isoformat().replace(
            "+00:00", "Z")

    for mod in (jctrl, tctrl):
        monkeypatch.setattr(mod, "_now_dt", now_dt)
    for mod in (jjobs, tjobs):
        monkeypatch.setattr(mod, "_now", now_iso)
    return now


def job(name, replicas=1, priority=None, queue=None, accelerator=None,
        profile=None, preemptible=None, elastic=None, kind="JaxJob"):
    """``tests/test_scheduler.py``'s job (elastic: (min, max))."""
    spec: dict = {
        "replicaSpecs": {
            "Worker": {
                "replicas": replicas,
                "restartPolicy": "OnFailure",
                "template": {"spec": {"containers": [
                    {"name": "main", "image": "train:latest"}]}},
            },
        },
    }
    for key, val in (("priority", priority), ("queue", queue),
                     ("profile", profile), ("preemptible", preemptible)):
        if val is not None:
            spec[key] = val
    if accelerator is not None:
        spec["tpu"] = {"accelerator": accelerator}
    if elastic is not None:
        spec["elastic"] = {"minReplicas": elastic[0],
                           "maxReplicas": elastic[1]}
    return {"apiVersion": jjobs_api.JOBS_API_VERSION, "kind": kind,
            "metadata": {"name": name, "namespace": NS}, "spec": spec}


class PatchRecorder:
    """A client proxy logging annotation patches (the shrink-vs-evict
    property is checked at patch granularity)."""

    def __init__(self, inner):
        self._inner = inner
        self.patches: list[tuple[str, dict]] = []

    def patch(self, api_version, kind, name, body, namespace=None):
        self.patches.append((name, body))
        return self._inner.patch(api_version, kind, name, body, namespace)

    def __getattr__(self, attr):
        return getattr(self._inner, attr)


class Twin:
    """JAX's cluster and the port's, driven by the same calls."""

    def __init__(self, clock, record: bool = False, **policy):
        self.clock = clock
        self.j, self.t = JFake(), TFake()
        for api in (self.j, self.t):
            api.ensure_namespace(NS)
        for crd in jjobs_api.all_job_crds():
            self.j.apply(crd)
        for crd in tjobs_api.all_job_crds():
            self.t.apply(crd)
        self.j.apply(jsched_api.scheduling_policy_crd())
        self.t.apply(tsched_api.scheduling_policy_crd())
        policy.setdefault("preemption", {"requeueBackoffSeconds": 0,
                                         "gracePeriodSeconds": 1})
        self.j.create(jsched_api.scheduling_policy(namespace=NS, **policy))
        self.t.create(tsched_api.scheduling_policy(
            namespace=NS, **self._port_policy(policy)))
        self.jrec, self.trec = PatchRecorder(self.j), PatchRecorder(self.t)
        self.jsched = jctrl.SchedulerController(
            self.jrec if record else self.j)
        self.tsched = tctrl.SchedulerController(
            self.trec if record else self.t)
        self.jjc = jjobs.JobController(self.j, "JaxJob")
        self.tjc = tjobs.JobController(self.t, "JaxJob")
        self.names: list[str] = []

    @staticmethod
    def _port_policy(spec: dict) -> dict:
        """JAX's default book under the mapping, the spec's profiles
        merged over it as JAX's book merges them."""
        spec = to_gpu(spec)
        profiles = to_gpu(copy.deepcopy(jcapacity.DEFAULT_PROFILES))
        for name, table in (spec.get("profiles") or {}).items():
            profiles.setdefault(name, {}).update(table)
        return {**spec, "profiles": profiles}

    # -- the cluster ----------------------------------------------------

    def add_slice(self, accel: str, slice_id: str, hosts: int) -> list[str]:
        names = [f"{slice_id}-h{i}" for i in range(hosts)]
        for n in names:
            self.j.create(jk8s.node(n, labels={
                jsched_api.NODE_ACCEL_LABEL: accel,
                jsched_api.NODE_TOPO_LABEL: "2x4",
                jsched_api.NODE_SLICE_LABEL: slice_id}, tpu_chips=4))
            self.t.create(tk8s.node(n, labels={
                tsched_api.NODE_ACCEL_LABEL: gpu_pool(accel),
                tsched_api.NODE_SLICE_LABEL: slice_id}, gpus=4))
        return names

    def delete_node(self, name: str) -> None:
        for api in (self.j, self.t):
            api.delete("v1", "Node", name)

    def create(self, obj: dict) -> None:
        self.j.create(obj)
        self.t.create(to_gpu(obj))
        self.names.append(obj["metadata"]["name"])

    def update_policy(self, **spec) -> None:
        pol = self.j.get(jsched_api.SCHEDULING_API_VERSION,
                         jsched_api.SCHEDULING_POLICY_KIND, "default", NS)
        pol["spec"].update(spec)
        self.j.update(pol)
        tpol = self.t.get(tsched_api.SCHEDULING_API_VERSION,
                          tsched_api.SCHEDULING_POLICY_KIND, "default", NS)
        tpol["spec"] = self._port_policy(pol["spec"])
        self.t.update(tpol)

    def set_phase(self, job_name: str, phase: str) -> None:
        for api in (self.j, self.t):
            for pod in pods_of(api, job_name):
                pod.setdefault("status", {})["phase"] = phase
                api.update_status(pod)

    def set_pod_phase(self, pod_name: str, phase: str) -> None:
        for api in (self.j, self.t):
            pod = api.get("v1", "Pod", pod_name, NS)
            pod.setdefault("status", {})["phase"] = phase
            api.update_status(pod)

    # -- the controllers ------------------------------------------------

    def sched(self) -> None:
        self.clock[0] += datetime.timedelta(seconds=1)
        self.jrec.patches.clear()
        self.trec.patches.clear()
        assert self.jsched.reconcile_all() == self.tsched.reconcile_all()
        self.check()

    def jc(self) -> None:
        assert self.jjc.reconcile_all() == self.tjc.reconcile_all()
        self.check()

    def run_gang(self, name, replicas=2, **kw) -> None:
        self.create(job(name, replicas=replicas, **kw))
        self.sched()
        self.jc()
        self.set_phase(name, "Running")
        self.jc()

    # -- the comparison -------------------------------------------------

    def check(self) -> None:
        for name in self.names:
            want = project_job(to_gpu(get_job(self.j, name)))
            got = project_job(get_job(self.t, name))
            assert got == want, name
            wpods = [project_pod(to_gpu(p)) for p in pods_of(self.j, name)]
            gpods = [project_pod(p) for p in pods_of(self.t, name)]
            assert gpods == wpods, name
        pol = (jsched_api.SCHEDULING_API_VERSION,
               jsched_api.SCHEDULING_POLICY_KIND, "default", NS)
        assert self.t.get(*pol).get("status") == \
            self.j.get(*pol).get("status")

    def state(self, name: str) -> str | None:
        return get_job(self.t, name).get("status", {}).get(
            "scheduling", {}).get("state")

    def placed(self, name: str) -> dict | None:
        return tsched_api.placement(get_job(self.t, name))

    def granted(self, name: str) -> int | None:
        decided = self.placed(name)
        return len(decided["nodes"]) if decided else None


def get_job(api, name, kind="JaxJob"):
    return api.get(jjobs_api.JOBS_API_VERSION, kind, name, NS)


def pods_of(api, name):
    return api.list("v1", "Pod", NS,
                    label_selector={"kubeflow-tpu.org/job-name": name})


def project_job(obj: dict) -> dict:
    """What a job's comparison reads: its annotations (the placement
    parsed, topology dropped), labels and status."""
    meta = obj["metadata"]
    ann = dict(meta.get("annotations") or {})
    raw = ann.pop(jsched_api.ANN_PLACEMENT, None)
    decided = json.loads(raw) if raw else None
    if decided is not None:
        decided.pop("topology")
    return {"annotations": ann, "placement": decided,
            "labels": meta.get("labels"), "status": obj.get("status")}


def project_pod(pod: dict) -> dict:
    """A pod's name, labels and annotations, placement, env (no
    ``TPU_*`` key) and status."""
    spec = pod["spec"]
    sel = dict(spec.get("nodeSelector") or {})
    sel.pop(JAX_TOPO_SELECTOR, None)
    envs = [{e["name"]: e.get("value") for e in c.get("env", [])
             if not e["name"].startswith("TPU_")}
            for c in spec["containers"]]
    return {"name": pod["metadata"]["name"],
            "labels": pod["metadata"].get("labels"),
            "annotations": pod["metadata"].get("annotations"),
            "nodeName": spec.get("nodeName"), "nodeSelector": sel,
            "hostname": spec.get("hostname"),
            "subdomain": spec.get("subdomain"), "env": envs,
            "status": pod.get("status")}


# ---------------------------------------------------------------------------
# the capacity model, the book and the queue
# ---------------------------------------------------------------------------


def test_capacity_pools_and_slices_from_gpu_nodes():
    L = tsched_api
    nodes = [
        tk8s.node("a0", {L.NODE_ACCEL_LABEL: "nvidia-h100-80gb",
                         L.NODE_SLICE_LABEL: "s0"}, gpus=8),
        tk8s.node("a1", {L.NODE_ACCEL_LABEL: "nvidia-h100-80gb",
                         L.NODE_SLICE_LABEL: "s0"}, gpus=8),
        tk8s.node("b0", {L.NODE_ACCEL_LABEL: "nvidia-a100-80gb"}, gpus=4),
        tk8s.node("dead", {L.NODE_ACCEL_LABEL: "nvidia-h100-80gb",
                           L.NODE_SLICE_LABEL: "s0"}, gpus=8, ready=False),
        tk8s.node("cordoned", {L.NODE_ACCEL_LABEL: "nvidia-h100-80gb",
                               L.NODE_SLICE_LABEL: "s0"}, gpus=8,
                  unschedulable=True),
        tk8s.node("cpu-only"),
        # A TPU host is not GPU capacity.
        jk8s.node("tpu", {jsched_api.NODE_ACCEL_LABEL: "v5e"}, tpu_chips=4),
    ]
    cap = tcapacity.ClusterCapacity.from_nodes(nodes)
    pools = cap.pools()
    assert set(pools) == {"nvidia-h100-80gb", "nvidia-a100-80gb"}
    (h100,) = pools["nvidia-h100-80gb"]
    assert (h100.nodes, h100.chips_per_host, h100.topology) == \
        (["a0", "a1"], 8, "")
    # A node without a slice label is a slice of its own.
    (a100,) = pools["nvidia-a100-80gb"]
    assert (a100.slice_id, a100.chips_per_host) == \
        ("nvidia-a100-80gb-b0", 4)
    assert cap.largest_slice() == 2 and cap.largest_slice(
        "nvidia-a100-80gb") == 1
    assert not jcapacity.ClusterCapacity.from_nodes(nodes[:3]).slices


def test_capacity_reserve_is_all_or_nothing():
    L = tsched_api
    cap = tcapacity.ClusterCapacity.from_nodes(
        [tk8s.node(f"h{i}", {L.NODE_ACCEL_LABEL: "nvidia-h100-80gb",
                             L.NODE_SLICE_LABEL: "s"}, gpus=1)
         for i in range(3)])
    (sl,) = cap.slices
    cap.occupy(["h0", "h1"], "other")
    with pytest.raises(ValueError):
        cap.reserve(sl, 2, "me")
    assert cap.free_hosts(sl) == ["h2"]
    assert cap.reserve(sl, 1, "me") == ["h2"]
    cap.release("other")
    assert len(cap.free_hosts(sl)) == 2
    assert not cap.feasible(3)
    assert cap.ever_fits(3) and not cap.ever_fits(4)


def test_throughput_book_knows_only_the_policy_profiles():
    """No built-in figure: without profiles every pool scores a neutral
    1.0 (JAX's score for an unknown pool); with JAX's default book under
    the mapping, every score equals JAX's."""
    empty = tcapacity.ThroughputBook()
    for pool in POOLS.values():
        assert empty.throughput(None, pool) == 1.0
        assert empty.score("flagship-1b", pool) == 1.0
    jbook = jcapacity.ThroughputBook({"bert": {"v5e": 10.0, "v5p": 40.0}})
    tbook = tcapacity.ThroughputBook(Twin._port_policy(
        {"profiles": {"bert": {"v5e": 10.0, "v5p": 40.0}}})["profiles"])
    for profile in (None, "default", "bert", "flagship-1b", "unknown"):
        for tpu, gpu in [*POOLS.items(), ("tpu9000", "gpu9000")]:
            assert tbook.score(profile, gpu) == jbook.score(profile, tpu)
            assert tbook.throughput(profile, gpu) == \
                jbook.throughput(profile, tpu)


@pytest.mark.parametrize("seed", [0, 1])
def test_order_queue_equals_jax(seed):
    rng = random.Random(seed)
    now = datetime.datetime(2026, 1, 1, tzinfo=datetime.timezone.utc)
    fields = [dict(key=("JaxJob", NS, f"j{i}"),
                   priority=rng.randint(0, 5),
                   queue=rng.choice(["default", "a", "b"]),
                   hosts=rng.randint(1, 3),
                   queued_at=now - datetime.timedelta(
                       seconds=rng.randint(0, 900)),
                   eligible_at=(now + datetime.timedelta(seconds=5)
                                if rng.random() < 0.2 else None))
              for i in range(12)]
    kw = dict(aging_seconds=300.0, queue_weights={"a": 2.0, "b": 0.5},
              used_share={"default": 3.0, "a": 2.0})
    want = jqueue.order_queue([jqueue.QueueEntry(**f) for f in fields],
                              now, **kw)
    got = tqueue.order_queue([tqueue.QueueEntry(**f) for f in fields],
                             now, **kw)
    assert [e.key for e in got] == [e.key for e in want]


def test_policy_crd_and_knobs_equal_jax():
    assert tsched_api.scheduling_policy_crd() == \
        jsched_api.scheduling_policy_crd()
    spec = {"agingSeconds": 7, "queues": [{"name": "a", "weight": 3}],
            "preemption": {"enabled": False, "minPriorityGap": 2},
            "elastic": {"growDelaySeconds": 9}}
    pol = tsched_api.scheduling_policy(namespace=NS, **spec)
    assert pol == jsched_api.scheduling_policy(namespace=NS, **spec)
    assert tsched_api.policy_knobs(pol) == jsched_api.policy_knobs(pol)


# ---------------------------------------------------------------------------
# admission
# ---------------------------------------------------------------------------


def test_admission_pins_gang_to_one_slice(clock):
    tw = Twin(clock)
    tw.add_slice("v5e", "e0", 2)
    tw.add_slice("v5e", "e1", 1)
    tw.create(job("gang", replicas=2, priority=1))
    tw.sched()
    tw.jc()
    decided = tw.placed("gang")
    assert (decided["pool"], decided["slice"], decided["nodes"],
            decided["topology"]) == ("nvidia-h100-80gb", "e0",
                                     ["e0-h0", "e0-h1"], "")
    pods = pods_of(tw.t, "gang")
    assert sorted(p["spec"]["nodeName"] for p in pods) == decided["nodes"]
    for p in pods:
        assert p["spec"]["nodeSelector"] == {
            tsched_api.NODE_ACCEL_LABEL: "nvidia-h100-80gb"}


def test_admission_prefers_measured_faster_pool(clock):
    tw = Twin(clock)
    tw.add_slice("v5e", "e0", 2)
    tw.add_slice("v5p", "p0", 2)
    tw.update_policy(profiles={"bert": {"v5e": 10.0, "v5p": 40.0}})
    tw.create(job("fast", replicas=2, priority=1, profile="bert"))
    tw.sched()
    assert tw.placed("fast")["pool"] == "nvidia-a100-80gb"
    # Without a profile the default book (v5p measured faster) decides.
    tw.create(job("plain", replicas=2, priority=1))
    tw.sched()
    assert tw.placed("plain")["pool"] == "nvidia-h100-80gb"


def test_unmanaged_job_keeps_the_first_come_path(clock):
    tw = Twin(clock)
    tw.create(job("legacy", replicas=2, accelerator="v5e"))
    tw.sched()
    tw.jc()
    assert tw.placed("legacy") is None
    for p in pods_of(tw.t, "legacy"):
        assert "nodeName" not in p["spec"]
        assert p["spec"]["nodeSelector"] == {
            tsched_api.NODE_ACCEL_LABEL: "nvidia-h100-80gb"}


def test_gang_waits_for_capacity_then_admits(clock):
    tw = Twin(clock)
    tw.add_slice("v5e", "e0", 2)
    tw.create(job("first", replicas=2, priority=1))
    tw.sched()
    tw.jc()
    tw.create(job("second", replicas=2, priority=1))
    for _ in range(3):
        tw.sched()
        tw.jc()
    assert tw.state("second") == tsched_api.STATE_QUEUED
    assert pods_of(tw.t, "second") == []
    tw.set_phase("first", "Succeeded")
    tw.jc()
    tw.sched()
    tw.jc()
    assert tw.state("second") == tsched_api.STATE_ADMITTED
    assert len(pods_of(tw.t, "second")) == 2


def test_unschedulable_condition_and_recovery(clock):
    tw = Twin(clock)
    tw.add_slice("v5e", "e0", 2)
    tw.create(job("toobig", replicas=3, priority=1))
    tw.sched()
    assert tw.state("toobig") == tsched_api.STATE_UNSCHEDULABLE
    tw.add_slice("v5e", "e1", 3)
    tw.sched()
    tw.jc()
    assert tw.state("toobig") == tsched_api.STATE_ADMITTED
    assert len(pods_of(tw.t, "toobig")) == 3


def test_accelerator_constraint_restricts_pools(clock):
    tw = Twin(clock)
    tw.add_slice("v5e", "e0", 2)
    tw.add_slice("v5p", "p0", 2)
    tw.create(job("pinned", replicas=2, priority=1, accelerator="v5p"))
    tw.sched()
    assert tw.placed("pinned")["pool"] == "nvidia-a100-80gb"
    tw.create(job("nowhere", replicas=1, priority=1, accelerator="v9x"))
    tw.sched()
    assert tw.state("nowhere") == tsched_api.STATE_UNSCHEDULABLE


def test_starved_low_priority_eventually_admitted_by_aging(clock):
    tw = Twin(clock, agingSeconds=0.02)
    tw.add_slice("v5e", "e0", 1)
    tw.create(job("hog", replicas=1, priority=5))
    tw.sched()
    tw.jc()
    tw.create(job("meek", replicas=1, priority=0))
    tw.sched()
    assert tw.state("meek") == tsched_api.STATE_QUEUED
    tw.create(job("fresh-high", replicas=1, priority=5))
    tw.set_phase("hog", "Succeeded")
    tw.jc()
    tw.sched()
    tw.jc()
    assert tw.state("meek") == tsched_api.STATE_ADMITTED
    assert tw.state("fresh-high") == tsched_api.STATE_QUEUED


# ---------------------------------------------------------------------------
# preemption and node loss
# ---------------------------------------------------------------------------


def test_priority_preemption_within_bounded_rounds(clock):
    tw = Twin(clock)
    tw.add_slice("v5e", "e0", 2)
    tw.run_gang("victim", priority=0)
    tw.create(job("vip", replicas=2, priority=10))
    tw.sched()
    for pod in pods_of(tw.t, "victim"):
        assert pod["metadata"]["annotations"][
            tsched_api.ANN_PREEMPTED_BY] == "JaxJob/kubeflow/vip"
        assert pod["status"]["phase"] == "Failed"
    tw.jc()
    assert get_job(tw.t, "victim")["status"]["preemptionCount"] == 1
    assert pods_of(tw.t, "victim") == []
    tw.sched()
    tw.jc()
    assert tw.state("vip") == tsched_api.STATE_ADMITTED
    tw.set_phase("vip", "Succeeded")
    tw.jc()
    tw.sched()
    tw.jc()
    assert tw.state("victim") == tsched_api.STATE_ADMITTED
    assert len(pods_of(tw.t, "victim")) == 2


def test_preemption_respects_preemptible_false_and_priority_gap(clock):
    tw = Twin(clock)
    tw.add_slice("v5e", "e0", 2)
    tw.run_gang("pinned", priority=0, preemptible=False)
    tw.create(job("equal", replicas=2, priority=0))
    tw.create(job("vip", replicas=2, priority=10))
    for _ in range(3):
        tw.sched()
        tw.jc()
    assert tw.placed("pinned") is not None
    assert tw.state("vip") == tsched_api.STATE_QUEUED


def test_preemption_picks_fewest_victims_slice(clock):
    tw = Twin(clock)
    tw.add_slice("v5e", "e0", 2)
    tw.add_slice("v5e", "e1", 2)
    tw.run_gang("one-gang", replicas=2, priority=0)
    tw.run_gang("small-a", replicas=1, priority=0)
    tw.run_gang("small-b", replicas=1, priority=0)
    tw.create(job("vip", replicas=2, priority=10))
    tw.sched()
    assert tw.state("one-gang") == tsched_api.STATE_PREEMPTED
    assert tw.placed("small-a") and tw.placed("small-b")


def test_node_loss_revokes_placement_and_reschedules(clock):
    tw = Twin(clock)
    tw.add_slice("v5e", "e0", 2)
    tw.run_gang("mobile", replicas=2, priority=1)
    tw.delete_node("e0-h0")
    tw.set_phase("mobile", "Failed")
    tw.sched()
    assert tw.placed("mobile") is None
    assert tw.state("mobile") == tsched_api.STATE_UNSCHEDULABLE
    tw.jc()
    assert pods_of(tw.t, "mobile") == []
    tw.add_slice("v5e", "e1", 2)
    tw.sched()
    tw.jc()
    assert tw.placed("mobile")["slice"] == "e1"
    assert len(pods_of(tw.t, "mobile")) == 2


# ---------------------------------------------------------------------------
# elastic: admission, shrink, grow
# ---------------------------------------------------------------------------


def test_elastic_admission_extends_grant_to_max(clock):
    tw = Twin(clock)
    tw.add_slice("v5e", "e0", 3)
    tw.create(job("stretchy", elastic=(1, 3), priority=1))
    tw.sched()
    tw.jc()
    assert tw.placed("stretchy")["elastic"] == {"granted": 3, "min": 1,
                                                "max": 3}
    (pod,) = pods_of(tw.t, "stretchy")
    assert pod["spec"]["nodeName"] == "e0-h0"


def test_elastic_degraded_admission_at_partial_capacity(clock):
    tw = Twin(clock)
    tw.add_slice("v5e", "e0", 2)
    tw.run_gang("occupant", replicas=1, priority=1)
    tw.create(job("flex", elastic=(1, 2), priority=1))
    tw.sched()
    assert tw.granted("flex") == 1


def test_shrink_before_preempt_seats_vip_without_killing(clock):
    tw = Twin(clock)
    tw.add_slice("v5e", "e0", 2)
    tw.create(job("victim", elastic=(1, 2), priority=0))
    tw.sched()
    tw.jc()
    tw.set_phase("victim", "Running")
    tw.jc()
    before = [p["metadata"]["name"] for p in pods_of(tw.t, "victim")]
    tw.create(job("vip", replicas=1, priority=10))
    tw.sched()
    assert tw.placed("victim")["nodes"] == ["e0-h0"]
    assert tw.placed("vip")["nodes"] == ["e0-h1"]
    tw.jc()
    assert [p["metadata"]["name"]
            for p in pods_of(tw.t, "victim")] == before


def test_shrink_at_floor_falls_back_to_preemption(clock):
    tw = Twin(clock)
    tw.add_slice("v5e", "e0", 2)
    tw.create(job("atfloor", replicas=1, elastic=(2, 2), priority=5))
    tw.sched()
    tw.jc()
    tw.create(job("vip", replicas=2, priority=10))
    tw.sched()
    assert tw.state("atfloor") == tsched_api.STATE_PREEMPTED


def test_shrink_reclaims_only_down_to_floor(clock):
    tw = Twin(clock)
    tw.add_slice("v5e", "e0", 3)
    tw.create(job("bounded", elastic=(2, 3), priority=0))
    tw.sched()
    tw.create(job("one", replicas=1, priority=10))
    tw.sched()
    assert tw.granted("bounded") == 2
    tw.create(job("two", replicas=2, priority=20))
    tw.sched()
    assert tw.state("bounded") == tsched_api.STATE_PREEMPTED


def test_grow_into_idle_capacity_after_completion(clock):
    tw = Twin(clock)
    tw.add_slice("v5e", "e0", 2)
    tw.run_gang("neighbor", replicas=1, priority=1)
    tw.create(job("flex", elastic=(1, 2), priority=1))
    tw.sched()
    tw.set_phase("neighbor", "Succeeded")
    tw.jc()
    tw.sched()
    assert tw.granted("flex") == 2


def test_grow_yields_to_queued_gang(clock):
    tw = Twin(clock)
    tw.add_slice("v5e", "e0", 2)
    tw.run_gang("neighbor", replicas=1, priority=1)
    tw.create(job("flex", elastic=(1, 2), priority=1))
    tw.sched()
    tw.create(job("queued", replicas=1, priority=1))
    tw.sched()
    tw.set_phase("neighbor", "Succeeded")
    tw.jc()
    tw.sched()
    assert tw.state("queued") == tsched_api.STATE_ADMITTED
    assert tw.granted("flex") == 1


def test_grow_delay_quiet_period(clock):
    tw = Twin(clock, elastic={"growDelaySeconds": 3600})
    tw.add_slice("v5e", "e0", 2)
    tw.create(job("calm", elastic=(1, 2), priority=0))
    tw.sched()
    tw.jc()
    tw.create(job("vip", replicas=1, priority=10))
    tw.sched()
    tw.set_phase("vip", "Succeeded")
    tw.jc()
    tw.sched()
    tw.sched()
    assert tw.granted("calm") == 1


def test_shrink_disabled_by_policy_falls_back_to_preempt(clock):
    tw = Twin(clock, elastic={"shrinkBeforePreempt": False})
    tw.add_slice("v5e", "e0", 2)
    tw.create(job("victim", elastic=(1, 2), priority=0))
    tw.sched()
    tw.create(job("vip", replicas=1, priority=10))
    tw.sched()
    assert tw.state("victim") == tsched_api.STATE_PREEMPTED


# ---------------------------------------------------------------------------
# randomized interleavings
# ---------------------------------------------------------------------------


def _placed_names(tw: Twin) -> list[str]:
    return [n for n in tw.names
            if tsched_api.placement(get_job(tw.t, n))
            and get_job(tw.t, n).get("status", {}).get("state")
            not in ("Succeeded", "Failed")]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_property_no_interleaving_partially_places_a_gang(seed, clock):
    """``tests/test_scheduler.py``'s property over both packages: the same
    random mix of gangs, reconcile interleavings, completions and pod
    failures; the worlds stay equal and, in the port's, every gang has 0
    or all of its pods and no host is double-booked."""
    rng = random.Random(seed)
    tw = Twin(clock, preemption={"requeueBackoffSeconds": 0})
    slices = {"e0": tw.add_slice("v5e", "e0", 3),
              "e1": tw.add_slice("v5e", "e1", 2),
              "p0": tw.add_slice("v5p", "p0", 4)}
    gangs = {}
    for i in range(8):
        gangs[f"j{i}"] = rng.randint(1, 4)
        tw.create(job(f"j{i}", replicas=gangs[f"j{i}"],
                      priority=rng.randint(0, 10)))

    def invariants():
        held = {}
        for name, gang in gangs.items():
            obj = get_job(tw.t, name)
            pods = pods_of(tw.t, name)
            assert len(pods) in (0, gang), (seed, name, len(pods))
            decided = tsched_api.placement(obj)
            if decided is None:
                continue
            assert set(decided["nodes"]) <= set(slices[decided["slice"]])
            if obj.get("status", {}).get("state") in ("Succeeded",
                                                      "Failed"):
                continue
            for node in decided["nodes"]:
                assert node not in held, (seed, node)
                held[node] = name

    for _ in range(50):
        op = rng.random()
        if op < 0.35:
            tw.sched()
        elif op < 0.7:
            tw.jc()
        elif op < 0.85:
            placed = _placed_names(tw)
            if placed:
                tw.set_phase(rng.choice(placed), "Succeeded")
                tw.check()
        else:
            alive = [p["metadata"]["name"] for p in tw.t.list("v1", "Pod", NS)
                     if p.get("status", {}).get("phase")
                     not in ("Succeeded", "Failed")]
            if alive:
                tw.set_pod_phase(rng.choice(alive), "Failed")
                tw.check()
        invariants()
    for _ in range(30):
        tw.sched()
        tw.jc()
        for name in _placed_names(tw):
            if len(pods_of(tw.t, name)) == gangs[name]:
                tw.set_phase(name, "Succeeded")
        tw.check()
        invariants()
    assert all(get_job(tw.t, n)["status"].get("state") == "Succeeded"
               for n in gangs)


def shape(patch: tuple[str, dict]) -> tuple:
    """A patch's target and what it sets: the annotations it names and
    whether it clears the placement."""
    name, body = patch
    ann = body.get("metadata", {}).get("annotations") or {}
    return (name, sorted(ann),
            ann.get(tsched_api.ANN_PLACEMENT, "") is None)


def test_property_shrink_grow_rounds_keep_invariants(clock):
    """The elastic property over both packages at one seed: a round never
    resizes and evicts one job, and the worlds stay equal."""
    rng = random.Random(0)
    tw = Twin(clock, record=True, preemption={"requeueBackoffSeconds": 0})
    tw.add_slice("v5e", "e0", 4)
    tw.add_slice("v5e", "e1", 3)
    for i in range(7):
        if rng.random() < 0.5:
            tw.create(job(f"j{i}", elastic=(1, rng.randint(2, 4)),
                          priority=rng.randint(0, 10)))
        else:
            tw.create(job(f"j{i}", replicas=rng.randint(1, 3),
                          priority=rng.randint(0, 10)))
    for _ in range(40):
        op = rng.random()
        if op < 0.4:
            tw.sched()
            assert [shape(p) for p in tw.trec.patches] == \
                [shape(p) for p in tw.jrec.patches]
            resized, evicted = set(), set()
            for name, body in tw.trec.patches:
                ann = body.get("metadata", {}).get("annotations") or {}
                if tsched_api.ANN_PLACEMENT not in ann:
                    continue
                if ann[tsched_api.ANN_PLACEMENT] is None:
                    evicted.add(name)
                elif tsched_api.ANN_PREEMPTED_BY not in ann:
                    resized.add(name)
            assert not resized & evicted
        elif op < 0.7:
            tw.jc()
        else:
            placed = _placed_names(tw)
            if placed:
                tw.set_phase(rng.choice(placed), "Succeeded")
                tw.check()


# ---------------------------------------------------------------------------
# the fault: managed GPU gangs never got pods
# ---------------------------------------------------------------------------


def test_gpu_trial_job_is_placed_by_the_port_and_never_by_jax():
    """A job-mode trial of the port's Experiment controller is a managed
    JaxJob asking for one GPU. On one GPU node JAX's scheduler finds no
    pool (it reads only TPU-labelled nodes), so JAX's job controller
    never creates its pod; the port's scheduler places it and the port's
    job controller creates its pod pinned to the node with the GPU
    selector and ``nvidia.com/gpu``."""
    from kubeflow_tpu_torch.apis.experiment import experiment, experiment_crd
    from kubeflow_tpu_torch.operators.experiment import ExperimentController

    api = TFake()
    api.ensure_namespace(NS)
    api.apply(experiment_crd())
    for crd in tjobs_api.all_job_crds():
        api.apply(crd)
    api.create(experiment("jm", NS, "decode-tps", algorithm="random",
                          max_trials=1, parallel_trials=1, seed=5,
                          trial_mode="job"))
    ExperimentController(api).reconcile_all()
    (trial,) = api.list(tjobs_api.JOBS_API_VERSION, "JaxJob", NS)
    assert tsched_api.is_managed(trial)
    node = tk8s.node("gpu-0", {tsched_api.NODE_ACCEL_LABEL:
                               "nvidia-h100-80gb"}, gpus=1)

    japi = JFake()
    japi.ensure_namespace(NS)
    for crd in jjobs_api.all_job_crds():
        japi.apply(crd)
    japi.apply(jsched_api.scheduling_policy_crd())
    japi.create(jsched_api.scheduling_policy(namespace=NS))
    japi.create(node)
    japi.create({k: v for k, v in trial.items() if k != "status"}
                | {"metadata": {"name": trial["metadata"]["name"],
                                "namespace": NS}})
    for _ in range(3):
        jctrl.SchedulerController(japi).reconcile_all()
        jjobs.JobController(japi, "JaxJob").reconcile_all()
    jtrial = japi.get(jjobs_api.JOBS_API_VERSION, "JaxJob",
                      trial["metadata"]["name"], NS)
    assert jsched_api.placement(jtrial) is None
    assert jtrial["status"]["scheduling"]["state"] == \
        jsched_api.STATE_UNSCHEDULABLE
    assert japi.list("v1", "Pod", NS) == []

    api.apply(tsched_api.scheduling_policy_crd())
    api.create(tsched_api.scheduling_policy(namespace=NS))
    api.create(node)
    tctrl.SchedulerController(api).reconcile_all()
    tjobs.JobController(api, "JaxJob").reconcile_all()
    got = api.get(tjobs_api.JOBS_API_VERSION, "JaxJob",
                  trial["metadata"]["name"], NS)
    assert tsched_api.placement(got)["nodes"] == ["gpu-0"]
    assert got["status"]["scheduling"]["state"] == \
        tsched_api.STATE_ADMITTED
    (pod,) = api.list("v1", "Pod", NS)
    assert pod["spec"]["nodeName"] == "gpu-0"
    assert pod["spec"]["nodeSelector"] == {
        "cloud.google.com/gke-accelerator": "nvidia-h100-80gb"}
    (c,) = pod["spec"]["containers"]
    assert c["resources"]["limits"] == {images.GPU_RESOURCE: 1}
    env = {e["name"]: e["value"] for e in c["env"]}
    assert env["KUBEFLOW_TPU_JOB_NAME"] == trial["metadata"]["name"]
    assert not [k for k in env if k.startswith("TPU_")]


def test_scheduler_metrics_in_the_port_registry(clock):
    from kubeflow_tpu_torch.operators.base import OPERATOR_METRICS

    tw = Twin(clock)
    tw.add_slice("v5e", "e0", 1)
    tw.create(job("one", priority=1))
    tw.sched()
    body = OPERATOR_METRICS.render()
    for family in ("scheduler_queue_depth", "scheduler_admissions_total",
                   "scheduler_placement_seconds"):
        assert f"# TYPE {family}" in body
    assert 'scheduler_admissions_total{pool="nvidia-h100-80gb"}' in body


def test_split_out_scheduler_places_over_http():
    """``python -m kubeflow_tpu_torch.scheduler --once`` against JAX's fake
    served over HTTP (the apiserver a deployment talks to): one round
    places a managed gang on GPU nodes through a merge patch."""
    import subprocess
    import sys
    from pathlib import Path

    from kubeflow_tpu.k8s.httpfake import serve

    fake = JFake()
    fake.ensure_namespace(NS)
    for crd in jjobs_api.all_job_crds():
        fake.apply(crd)
    fake.apply(jsched_api.scheduling_policy_crd())
    fake.create(jsched_api.scheduling_policy(namespace=NS))
    for i in range(2):
        fake.create(tk8s.node(f"gpu-{i}", {
            tsched_api.NODE_ACCEL_LABEL: "nvidia-h100-80gb",
            tsched_api.NODE_SLICE_LABEL: "s0"}, gpus=8))
    fake.create(job("gang", replicas=2, priority=1))
    httpd, port = serve(fake)
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "kubeflow_tpu_torch.scheduler", "--once",
             "--apiserver", f"http://127.0.0.1:{port}", "--alsologtostderr",
             "-v=1"], cwd=Path(__file__).resolve().parent.parent,
            capture_output=True, text=True, timeout=60)
    finally:
        httpd.shutdown()
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == \
        {"reconciled": 1, "controllers": 1}
    got = get_job(fake, "gang")
    decided = tsched_api.placement(got)
    assert (decided["pool"], decided["nodes"]) == \
        ("nvidia-h100-80gb", ["gpu-0", "gpu-1"])
    assert got["status"]["scheduling"]["state"] == \
        tsched_api.STATE_ADMITTED
