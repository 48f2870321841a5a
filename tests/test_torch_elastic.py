"""The port's elastic pieces against the JAX package, on the CPU.

- ``scaled_mesh_config`` equals JAX's over a grid of meshes and counts,
  raising where JAX's raises; ``ReshardStats.to_dict`` gives JAX's dict.
- ``reshard_state`` in gangs of four gloo processes: a trained state 4 ->
  2 -> 4 ranks over dp, dp x fsdp and dp x tp, bit for bit each hop
  (``method`` "device": the rank sets overlap), a shrink moving nothing
  to the ranks that stay; ranks {0, 1} -> {2, 3} (disjoint) through the
  host (``method`` "host").
- ``placement_device_source`` answers as JAX's on JAX's cases
  (``tests/test_elastic.py``), ``publish_metrics`` writes the same
  ``status.metrics`` as JAX's to a job JAX's fake apiserver serves over
  HTTP, and a missing job or a refused connection only logs.
- One loop gang of four runs JAX's loop checks: an infeasible target (3
  on fsdp 2) ignored and logged once, a target beyond the gang rejected,
  the initial grant shaping the first mesh (the ranks outside it return
  the same result), and a live shrink whose reshard metric families
  render with JAX's help, type lines, labels and buckets.

The loop's reshard point against the restore reference and JAX's elastic
run: ``tests/test_torch_elastic_loop.py``. Every gang runs under a 120 s
limit.
"""

import json
import os
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# Six test workers share the host's cores.
torch.set_num_threads(2)

from kubeflow_tpu.apis import jobs as jobs_api  # noqa: E402
from kubeflow_tpu.apis import scheduling as sched_api  # noqa: E402
from kubeflow_tpu.k8s.client import ClusterConfig as JClusterConfig  # noqa: E402,E501
from kubeflow_tpu.k8s.client import HttpK8sClient as JHttpK8sClient  # noqa: E402,E501
from kubeflow_tpu.k8s.fake import FakeApiServer  # noqa: E402
from kubeflow_tpu.k8s.httpfake import serve  # noqa: E402
from kubeflow_tpu.observability.metrics import MetricRegistry as JRegistry  # noqa: E402,E501
from kubeflow_tpu.parallel import reshard as jreshard  # noqa: E402
from kubeflow_tpu.parallel.mesh import MeshConfig as JMeshConfig  # noqa: E402
from kubeflow_tpu.train import elastic as jelastic  # noqa: E402
from kubeflow_tpu.train import loop as jloop  # noqa: E402
from kubeflow_tpu_torch import k8s_client  # noqa: E402
from kubeflow_tpu_torch.parallel import reshard as treshard  # noqa: E402
from kubeflow_tpu_torch.parallel.launch import free_port, launch  # noqa: E402
from kubeflow_tpu_torch.parallel.mesh import MeshConfig as TMeshConfig  # noqa: E402,E501
from kubeflow_tpu_torch.train import elastic as telastic  # noqa: E402
from kubeflow_tpu_torch.train import loop as tloop  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GANG_TIMEOUT_S = 120
# tests/test_elastic.py's model: the smallest that splits over tensor 2.
TINY = {"n_layers": 1, "d_model": 32, "d_ff": 64, "n_heads": 2,
        "n_kv_heads": 2}


def _gang(code: str, args: dict, n: int = 4):
    procs = launch([sys.executable, "-c", code, json.dumps(args)], n,
                   env=dict(os.environ, OMP_NUM_THREADS="1"), cwd=ROOT,
                   timeout=GANG_TIMEOUT_S)
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"rank {i}:\n{p.stderr[-3000:]}"
    return [json.loads(p.stdout.strip().splitlines()[-1]) for p in procs]


# ---------------------------------------------------------------------------
# the mesh arithmetic and the stats record
# ---------------------------------------------------------------------------

SCALED_BASES = {
    "default": {},
    "dp_fsdp2": {"data": -1, "fsdp": 2},
    "dp2_tp2": {"data": 2, "tensor": 2},
    "fsdp2": {"fsdp": 2},
    "fsdp_wildcard": {"data": 2, "fsdp": -1},
    "expert2_tp2": {"expert": 2, "tensor": 2},
    "pp2_seq2_ici": {"pipeline": 2, "sequence": 2, "ici_axes": ("tensor",)},
}


@pytest.mark.parametrize("base", list(SCALED_BASES))
def test_scaled_mesh_config_matches_jax(base):
    kw = SCALED_BASES[base]
    for n in range(0, 10):
        try:
            want = jreshard.scaled_mesh_config(JMeshConfig(**kw), n)
        except ValueError as e:
            with pytest.raises(ValueError, match=re.escape(str(e))):
                treshard.scaled_mesh_config(TMeshConfig(**kw), n)
            continue
        got = treshard.scaled_mesh_config(TMeshConfig(**kw), n)
        assert got.degrees() == want.degrees(), n
        assert tuple(got.ici_axes) == tuple(want.ici_axes)


def test_reshard_stats_dict_is_jax_s():
    for frm, to, method in ((4, 8, "device"), (8, 4, "host"),
                            (4, 4, "device")):
        kw = dict(from_devices=frm, to_devices=to, method=method, leaves=7,
                  bytes=1234, seconds=0.1234567)
        got = treshard.ReshardStats(**kw)
        want = jreshard.ReshardStats(**kw)
        assert got.to_dict() == want.to_dict()
        assert got.direction == want.direction


# ---------------------------------------------------------------------------
# reshard_state in gangs of four
# ---------------------------------------------------------------------------

# One rank: train lm-test-tiny 2 steps on a mesh of 4, then move the state
# 4 -> 2 -> 4 ranks, then 4 -> {0, 1} -> {2, 3}; after each hop the state
# gathered on the first rank of the new mesh is held bit for bit against
# the one before the first hop.
RESHARD_WORKER = """
import json, sys, torch
torch.set_num_threads(1)
from kubeflow_tpu_torch.models.registry import get_model
from kubeflow_tpu_torch.parallel import reshard
from kubeflow_tpu_torch.parallel.distributed import (broadcast_object,
    initialize_from_env, shutdown)
from kubeflow_tpu_torch.parallel.mesh import (BATCH_AXES, MeshConfig,
    axis_index, axis_size, build_mesh, destroy_mesh, is_member)
from kubeflow_tpu_torch.train import data, trainer
from kubeflow_tpu_torch.train.optimizers import OptimizerConfig
from kubeflow_tpu_torch.weights import flatten
a = json.loads(sys.argv[1])
info = initialize_from_env(device="cpu", timeout_s=120)
model = get_model("lm-test-tiny", dtype=torch.float32, **a["tiny"])
opt = OptimizerConfig(name="adafactor", learning_rate=1e-2, warmup_steps=1)
base = MeshConfig(**a["mesh"])
rules, tokens = model.partition_rules(model.config), trainer.token_axes(model)

def mesh_on(ranks):
    return build_mesh(reshard.scaled_mesh_config(base, len(ranks)),
                      device_type="cpu", ranks=ranks)

m = mesh_on(range(4))
state = trainer.init_state(torch.Generator().manual_seed(0), model, opt, m,
                           device="cpu")
step = trainer.build_train_step(model, opt, m)
for i in range(2):
    b = data.local_rows(data.synthetic_batch(model, 8, 16, seed=i),
                        axis_index(m, BATCH_AXES), axis_size(m, BATCH_AXES))
    state, _ = step(state, data.place_batch(b, torch.device("cpu")))
shapes = state.layout.shapes

def flat(st):
    out = {f"params/{k}": t for k, t in flatten(st.params).items()}
    for slot, v in st.opt_state.items():
        out.update({slot: v} if slot == "count" else
                   {f"{slot}/{k}": t for k, t in v.items()})
    return out

def gathered(st, mesh):
    first = int(mesh.mesh.reshape(-1)[0])
    whole = st.layout.gather_state(st, dst=first) if st is not None else None
    return broadcast_object(None if whole is None else flat(whole), first)

ref = gathered(state, m)
hops = []
for ranks in ([0, 1], [0, 1, 2, 3], [0, 1], [2, 3]):
    new = mesh_on(ranks)
    src = state.layout if state is not None else trainer.StateLayout(
        m, rules, shapes, tokens)
    dst = trainer.StateLayout(new, rules, shapes, tokens)
    before = dict(reshard.MOVED)
    res = reshard.reshard_state(state, src, dst)
    destroy_mesh(m)
    state, m = res.tree, new
    assert (state is None) == (not is_member(m))
    got = gathered(state, m)
    same = set(got) == set(ref) and all(
        (got[k] == ref[k]) if k == "count" else torch.equal(got[k], ref[k])
        for k in ref)
    hops.append({"ranks": ranks, "stats": res.stats.to_dict(),
                 "bit_equal": bool(same), "member": is_member(m),
                 "received": reshard.MOVED["received"] - before["received"]})
print(json.dumps({"rank": info.process_id, "hops": hops}))
shutdown()
"""

RESHARD_MESHES = {"dp": {"data": -1}, "dp_fsdp": {"data": -1, "fsdp": 2},
                  "dp_tp": {"data": -1, "tensor": 2}}


@pytest.mark.parametrize("mesh", list(RESHARD_MESHES))
def test_reshard_state_round_trips_bit_for_bit(mesh):
    ranks = _gang(RESHARD_WORKER, {"mesh": RESHARD_MESHES[mesh],
                                   "tiny": TINY})
    for r in ranks:
        down, up, again, moved = r["hops"]
        for hop in r["hops"]:
            assert hop["bit_equal"], (r["rank"], hop)
        assert down["stats"]["direction"] == "shrink"
        assert up["stats"]["direction"] == "grow"
        for hop in (down, up, again):
            assert hop["stats"]["method"] == "device"
        assert moved["stats"]["method"] == "host"
        assert (down["stats"]["from_devices"], down["stats"]["to_devices"]) \
            == (4, 2)
        # The whole logical state, the same count on every rank.
        assert down["stats"]["bytes"] == ranks[0]["hops"][0]["stats"]["bytes"]
        assert down["stats"]["leaves"] > 0
        # A shrink moves nothing to the ranks that stay; a grow sends the
        # new ranks their data peers' shards and nothing to the others.
        assert down["received"] == 0
        assert (up["received"] > 0) == (r["rank"] >= 2)
        assert moved["member"] == (r["rank"] >= 2)
        assert (moved["received"] > 0) == (r["rank"] >= 2)


# ---------------------------------------------------------------------------
# the placement poller and the job-status publish
# ---------------------------------------------------------------------------


def _job_with_grant(granted, cap, nodes=None):
    nodes = nodes if nodes is not None else [f"h{i}" for i in range(granted)]
    return {
        "apiVersion": "kubeflow-tpu.org/v1", "kind": "JaxJob",
        "metadata": {"name": "ej", "namespace": "ns", "annotations": {
            sched_api.ANN_PLACEMENT: sched_api.encode_placement(
                "v5e", "2x4", "v5e-0", nodes, "t0",
                elastic={"granted": granted, "min": 1, "max": cap}),
        }},
        "spec": {"priority": 1, "elastic": {"minReplicas": 1,
                                            "maxReplicas": cap}},
    }


class _StubClient:
    def __init__(self, job=None, error=None):
        self.job = job
        self.error = error

    def get(self, api_version, kind, name, ns):
        assert (api_version, kind, name, ns) == (
            "kubeflow-tpu.org/v1", "JaxJob", "ej", "ns")
        if self.error is not None:
            raise self.error
        return self.job


def test_placement_device_source_answers_as_jax():
    env = {"KUBEFLOW_TPU_JOB_NAME": "ej", "KUBEFLOW_TPU_JOB_NAMESPACE": "ns",
           "KUBEFLOW_TPU_JOB_KIND": "JaxJob"}
    bare = _job_with_grant(2, 2)
    del bare["metadata"]["annotations"]
    malformed = _job_with_grant(1, 2)
    malformed["metadata"]["annotations"][sched_api.ANN_PLACEMENT] = "{"
    cases = [_StubClient(_job_with_grant(1, 2)),
             _StubClient(_job_with_grant(2, 2)),
             _StubClient(_job_with_grant(3, 4)),
             _StubClient(_job_with_grant(1, 8)),
             _StubClient(error=ConnectionError("down")),
             _StubClient(bare), _StubClient(malformed)]
    answers = []
    for client in cases:
        for total in (8, 4, 3):
            want = jelastic.placement_device_source(
                environ=env, client=client, total_devices=total)()
            got = telastic.placement_device_source(
                environ=env, client=client, total_devices=total)()
            assert got == want, (client.job, total)
            answers.append(got)
    assert answers[:2] == [4, 2] and None in answers
    # No job identity: no source at all.
    assert telastic.placement_device_source(environ={},
                                            client=_StubClient()) is None
    assert jelastic.placement_device_source(environ={},
                                            client=_StubClient()) is None
    # The gang's devices by default: one process, no process group.
    poll = telastic.placement_device_source(
        environ=env, client=_StubClient(_job_with_grant(2, 2)))
    assert poll() == 1


@pytest.fixture()
def served_jobs():
    fake = FakeApiServer()
    fake.ensure_namespace("kubeflow")
    for crd in jobs_api.all_job_crds():
        fake.create(crd)
    for name in ("jax-job", "port-job"):
        fake.create({
            "apiVersion": jobs_api.JOBS_API_VERSION, "kind": "JaxJob",
            "metadata": {"name": name, "namespace": "kubeflow"},
            "spec": {"replicaSpecs": {"Worker": {
                "replicas": 1, "template": {"spec": {"containers": [
                    {"name": "main", "image": "i"}]}}}}}})
    httpd, port = serve(fake)
    yield fake, f"http://127.0.0.1:{port}"
    httpd.shutdown()


RESULT = {"step": 6, "loss": 1.5, "samples_per_sec": 12.25,
          "process_id": 0, "preempted": False, "devices": 4,
          "reshards": [{"step": 3}], "note": "text"}


def _env(name):
    return {"KUBEFLOW_TPU_JOB_NAME": name,
            "KUBEFLOW_TPU_JOB_NAMESPACE": "kubeflow",
            "KUBEFLOW_TPU_JOB_KIND": "JaxJob"}


def _status(fake, name):
    return fake.get(jobs_api.JOBS_API_VERSION, "JaxJob", name,
                    "kubeflow")["status"]["metrics"]


def test_publish_metrics_writes_the_job_status_as_jax(served_jobs,
                                                      monkeypatch):
    fake, host = served_jobs
    jlines, tlines = [], []
    jclient = JHttpK8sClient(JClusterConfig(host=host))
    for crd in jobs_api.all_job_crds():
        jclient._registry.register_crd(crd)
    jloop.publish_metrics(RESULT, client=jclient, environ=_env("jax-job"),
                          log=jlines.append)
    tloop.publish_metrics(
        RESULT, client=k8s_client.HttpK8sClient(
            k8s_client.ClusterConfig(host=host)),
        environ=_env("port-job"), log=tlines.append)
    assert _status(fake, "port-job") == _status(fake, "jax-job") == {
        "step": 6, "loss": 1.5, "samples_per_sec": 12.25, "process_id": 0,
        "preempted": False, "devices": 4}
    assert tlines == jlines and len(tlines) == 1
    # The default client (the apiserver proxy's address) publishes too.
    monkeypatch.setattr(k8s_client.ClusterConfig.__init__, "__defaults__",
                        (host, None, True))
    tloop.publish_metrics(dict(RESULT, step=7), environ=_env("port-job"),
                          log=tlines.append)
    assert _status(fake, "port-job")["step"] == 7


def test_publish_metrics_failures_only_log(served_jobs):
    _fake, host = served_jobs
    jlines, tlines = [], []
    jclient = JHttpK8sClient(JClusterConfig(host=host))
    for crd in jobs_api.all_job_crds():
        jclient._registry.register_crd(crd)
    jloop.publish_metrics(RESULT, client=jclient, environ=_env("missing"),
                          log=jlines.append)
    tloop.publish_metrics(
        RESULT, client=k8s_client.HttpK8sClient(
            k8s_client.ClusterConfig(host=host)),
        environ=_env("missing"), log=tlines.append)
    assert tlines[-1] == jlines[-1]
    assert tlines[-1].startswith("metrics publish failed: 404 NotFound")
    refused = k8s_client.HttpK8sClient(
        k8s_client.ClusterConfig(host=f"http://127.0.0.1:{free_port()}"))
    tloop.publish_metrics(RESULT, client=refused, environ=_env("port-job"),
                          log=tlines.append)
    assert tlines[-1].startswith("metrics publish failed:")
    with pytest.raises(OSError):
        refused.get(jobs_api.JOBS_API_VERSION, "JaxJob", "port-job",
                    "kubeflow")
    # No job identity: the log line only.
    tloop.publish_metrics(RESULT, client=refused, environ={},
                          log=tlines.append)
    assert tlines[-1].startswith("kubeflow-tpu-metrics: ")


def test_the_package_imports_no_requests():
    """The GPU image has no ``requests``: the apiserver client is urllib,
    and no module of the package pulls ``requests`` in."""
    import subprocess

    code = ("import importlib, pkgutil, sys\n"
            "import kubeflow_tpu_torch as pkg\n"
            "for m in pkgutil.walk_packages(pkg.__path__, "
            "pkg.__name__ + '.'):\n"
            "    importlib.import_module(m.name)\n"
            "sys.exit(1 if any(n == 'requests' or n.startswith('requests.')"
            " for n in sys.modules) else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# ---------------------------------------------------------------------------
# JAX's loop checks in one gang of four
# ---------------------------------------------------------------------------

# One rank: four runs of the loop with an injected source, each one's
# result and (rank 0) log lines, and the reshard families' exposition.
LOOP_WORKER = """
import json, sys, torch
torch.set_num_threads(1)
from kubeflow_tpu_torch.parallel.distributed import (initialize_from_env,
    shutdown)
from kubeflow_tpu_torch.train import elastic, loop
from kubeflow_tpu_torch.train.optimizers import OptimizerConfig
a = json.loads(sys.argv[1])
info = initialize_from_env(device="cpu", timeout_s=120)

def drive(mesh, source, steps):
    lines = []
    cfg = loop.RunConfig(
        model="lm-test-tiny", model_overrides=a["tiny"], mesh=mesh,
        optimizer=OptimizerConfig(learning_rate=1e-2, warmup_steps=2,
                                  total_steps=50),
        batch_size=8, seq_len=16, steps=steps, log_every=1,
        graceful_shutdown=False, device="cpu")
    result = loop.run(cfg, log=lambda *x: lines.append(
        " ".join(map(str, x))), mesh_source=source)
    return {"result": result, "lines": lines}

calls = []

def shrink_at_step_1():
    calls.append(1)  # the first mesh's poll, then one a step
    return 2 if len(calls) > 2 else 4

out = {"infeasible": drive({"data": -1, "fsdp": 2}, lambda: 3, 4),
       "beyond": drive({"data": -1}, lambda: 16, 3),
       "initial": drive({"data": -1}, lambda: 2, 3),
       "shrink": drive({"data": -1}, shrink_at_step_1, 3),
       "exposition": elastic.ELASTIC_METRICS.render()}
print(json.dumps(out))
shutdown()
"""


@pytest.fixture(scope="module")
def loop_gang():
    return _gang(LOOP_WORKER, {"tiny": TINY})


def test_infeasible_target_ignored_and_logged_once(loop_gang):
    for r in loop_gang:
        run = r["infeasible"]["result"]
        assert run["reshard_count"] == 0 and run["step"] == 4
        assert run["devices"] == 4
    lines = loop_gang[0]["infeasible"]["lines"]
    rejects = [ln for ln in lines if "ignoring reshard target 3" in ln]
    assert rejects == ["ignoring reshard target 3: 3 devices not divisible "
                       "by the fixed axes' product 2 — cannot scale the "
                       "data axis"], lines


def test_target_beyond_the_gang_rejected(loop_gang):
    for r in loop_gang:
        assert r["beyond"]["result"]["reshard_count"] == 0
    lines = loop_gang[0]["beyond"]["lines"]
    assert [ln for ln in lines if "ignoring reshard target 16" in ln] == [
        "ignoring reshard target 16: only 4 device(s) in this gang"]


def test_initial_grant_shapes_first_mesh(loop_gang):
    results = [r["initial"]["result"] for r in loop_gang]
    for r in results:
        assert r["devices"] == 2 and r["reshard_count"] == 0
        assert r["step"] == 3
        # The ranks outside the mesh return the mesh's loss.
        assert r["loss"] == results[0]["loss"] is not None
    # Only the two members trained (a step time each step).
    assert [r["step_time_p50_ms"] > 0 for r in results] == [
        True, True, False, False]
    assert sum(ln.startswith("step=")
               for ln in loop_gang[0]["initial"]["lines"]) == 3


def test_reshard_metric_families_render_as_jax(loop_gang):
    for r in loop_gang:
        run = r["shrink"]["result"]
        assert run["reshard_count"] == 1 and run["devices"] == 2
        event = run["reshards"][0]
        assert event["step"] == 1 and event["direction"] == "shrink"
        assert set(event) == {"from_devices", "to_devices", "direction",
                              "method", "leaves", "bytes", "seconds",
                              "step", "downtime_seconds"}
    assert "resharded shrink 4->2 devices at step 1 in " in "\n".join(
        loop_gang[0]["shrink"]["lines"])
    body = loop_gang[0]["exposition"]
    # JAX's families, registered the same way on a registry of their own.
    jreg = JRegistry()
    jreg.counter(jelastic.M_RESHARDS.name, jelastic.M_RESHARDS.help,
                 labels=("direction",)).labels("shrink").inc()
    jreg.histogram(jelastic.M_RESHARD_SECONDS.name,
                   jelastic.M_RESHARD_SECONDS.help).observe(0.5)
    want = jreg.render()
    for line in want.splitlines():
        if line.startswith("#"):
            assert line in body.splitlines(), line
    assert 'train_reshards_total{direction="shrink"} 1' in body
    assert "train_reshard_seconds_count 1" in body

    def buckets(text):
        return re.findall(r'train_reshard_seconds_bucket\{le="([^"]+)"\}',
                          text)

    assert buckets(body) == buckets(want) and len(buckets(body)) > 1
    np.testing.assert_array_less(0, float(re.search(
        r"train_reshard_seconds_sum (\S+)", body).group(1)))
