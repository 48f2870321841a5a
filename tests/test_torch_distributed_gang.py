"""Gangs of the port's entry points on the CPU over gloo, as a user starts
them: ``python -m kubeflow_tpu_torch.train.loop '<json>'`` with the JaxJob
environment (``parallel.launch``) and ``"device": "cpu"``, and the three
workloads.

- A loop gang at fsdp=2 and at data=2 x fsdp=2 on a token file (each
  process reads its shard, so the ranks' rows differ), widths overridden
  so adafactor factors the sharded leaves, from the JAX initial state
  (a step-0 checkpoint): the checkpoints it writes after each step equal
  JAX's mesh train state over the processes' rows concatenated, and its
  final loss JAX's; only process 0 logs.
- A checkpoint written by 2 ranks (fsdp=2) resumes in one process equal
  to the 2-rank gang's straight run (the synthetic stream is the same on
  every process, so the global batch is one process's batch twice, whose
  mean loss and gradient one process computes alone).
- A SIGTERM to one rank: every rank stops and saves at the same step.
- BERT over a sequence axis of 2 raises "not yet ported" on every rank
  before any step (the MoE gangs over every axis the port trains:
  tests/test_torch_moe_parallel.py).
- An elastic gang (``elastic_poll_steps``) starts on the job's grant read
  from JAX's fake apiserver over HTTP: one rank of two.
- The allreduce smoke test, the bandwidth benchmark and the DDP workload
  print the JAX workloads' JSON at 2 ranks; the benchmark publishes its
  peak into the job's status.

Tolerances are ``tests/test_torch_train.py``'s (float32 with sums in
another order): losses 1e-5 relative, states 1e-4 relative and 1e-5
absolute. Every gang runs under a 120 s limit.
"""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# Six test workers share the host's cores: cap torch's intra-op
# threads so the timing tests of other files keep their cadence.
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from kubeflow_tpu.models import registry as jregistry  # noqa: E402
from kubeflow_tpu.parallel.mesh import MeshConfig as JMeshConfig  # noqa: E402
from kubeflow_tpu.parallel.mesh import build_mesh as jbuild_mesh  # noqa: E402
from kubeflow_tpu.parallel.sharding import path_str  # noqa: E402
from kubeflow_tpu.train import optimizers as joptim  # noqa: E402
from kubeflow_tpu.train import trainer as jtrainer  # noqa: E402
from kubeflow_tpu.train.tokenstore import TokenStore as JTokenStore  # noqa: E402,E501
from kubeflow_tpu_torch import weights  # noqa: E402
from kubeflow_tpu_torch.parallel import launch  # noqa: E402
from kubeflow_tpu_torch.train import checkpoint as tcheckpoint  # noqa: E402
from kubeflow_tpu_torch.train import loop as tloop  # noqa: E402
from kubeflow_tpu_torch.train import optimizers as toptim  # noqa: E402
from kubeflow_tpu_torch.train.tokenstore import write_token_file  # noqa: E402,E501

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GANG_TIMEOUT_S = 120
LOOP = [sys.executable, "-m", "kubeflow_tpu_torch.train.loop"]
WIDE = dict(d_model=128, d_ff=256)
OPT = dict(name="adafactor", learning_rate=1e-2, warmup_steps=1,
           total_steps=10)


def _env(**extra):
    return dict(os.environ, OMP_NUM_THREADS="1", **extra)


def _gang(cmd, n, **env):
    return launch.launch(cmd, n, env=_env(**env), cwd=ROOT,
                         timeout=GANG_TIMEOUT_S)


def _ok(procs):
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"rank {i}:\n{p.stderr[-3000:]}"
    return procs


def _result(proc) -> dict:
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _jax_flat(jstate):
    return {path_str(p): np.asarray(leaf) for p, leaf in
            jax.tree_util.tree_flatten_with_path(jstate)[0]}


def _assert_states_close(got: dict, want: dict, keys=None):
    for path in keys or want:
        np.testing.assert_allclose(got[path], want[path], rtol=1e-4,
                                   atol=1e-5, err_msg=path)


@pytest.mark.parametrize("mesh", [{"fsdp": 2}, {"data": 2, "fsdp": 2}],
                         ids=["fsdp2", "data2xfsdp2"])
def test_loop_gang_on_a_token_file_matches_jax(mesh, tmp_path):
    w = int(np.prod(list(mesh.values())))
    batch, seq, steps = 2, 16, 3
    corpus = str(tmp_path / "corpus.ktpu")
    write_token_file(corpus, np.random.default_rng(0).integers(0, 256, 4000))
    jm = jregistry.get_model("lm-test-tiny", dtype=jnp.float32, **WIDE)
    jcfg = joptim.OptimizerConfig(**OPT)
    jmesh = jbuild_mesh(JMeshConfig(**mesh), devices=jax.devices()[:w])
    jstate = jtrainer.init_state(jax.random.PRNGKey(0), jm, jcfg, jmesh)
    ckpt_dir = str(tmp_path / "ckpt")
    tcfg = toptim.OptimizerConfig(**OPT)
    tcheckpoint.save(ckpt_dir, 0, weights.state_from_numpy(
        _jax_flat(jstate), tcfg, device="cpu"), tcfg)

    cfg = dict(model="lm-test-tiny", model_overrides=dict(
        WIDE, dtype="float32"), batch_size=batch, seq_len=seq, steps=steps,
        log_every=1, device="cpu", mesh=mesh, optimizer=OPT,
        data_path=corpus, checkpoint_dir=ckpt_dir, checkpoint_every=1,
        checkpoint_async=False)
    procs = _ok(_gang(LOOP + [json.dumps(cfg)], w))

    # JAX over the processes' rows, one after another (shard p of w).
    store = JTokenStore(corpus)
    streams = [store.stream(batch, seq, seed=0, shard=p, num_shards=w)
               for p in range(w)]
    jstep = jtrainer.build_train_step(jm, jcfg, jmesh)
    for step in range(1, steps + 1):
        tokens = np.concatenate([next(s)["tokens"] for s in streams])
        jstate, jmet = jstep(jstate, {"tokens": jnp.asarray(tokens)})
        got = tcheckpoint._load(ckpt_dir, step)
        _assert_states_close(got, _jax_flat(jstate))
    store.close()
    results = [_result(p) for p in procs]
    assert [r["process_id"] for r in results] == list(range(w))
    for r in results:
        assert r["step"] == steps and r["devices"] == w
        np.testing.assert_allclose(r["loss"], float(jmet["loss"]),
                                   rtol=1e-5)
    assert "resumed from checkpoint step 0" in procs[0].stdout
    assert sum(line.startswith("step=")
               for line in procs[0].stdout.splitlines()) == steps
    for p in procs[1:]:  # only process 0 logs
        assert "step=" not in p.stdout and "kubeflow-tpu-metrics" \
            not in p.stdout


COMMON = dict(model="lm-test-tiny", model_overrides=dict(WIDE,
                                                         dtype="float32"),
              batch_size=2, seq_len=16, log_every=1, device="cpu",
              optimizer=OPT, checkpoint_async=False)


def test_two_rank_checkpoint_resumes_in_one_process(tmp_path):
    straight, part = str(tmp_path / "straight"), str(tmp_path / "part")
    gang = dict(COMMON, mesh={"fsdp": 2})
    _ok(_gang(LOOP + [json.dumps(dict(gang, steps=4,
                                      checkpoint_dir=straight))], 2))
    _ok(_gang(LOOP + [json.dumps(dict(gang, steps=2,
                                      checkpoint_dir=part))], 2))
    lines = []
    res = tloop.run(tloop.RunConfig(
        **dict(COMMON, optimizer=toptim.OptimizerConfig(**OPT)), steps=4,
        checkpoint_dir=part), log=lines.append)
    assert lines[0] == "resumed from checkpoint step 2"
    assert res["step"] == 4 and res["devices"] == 1
    assert tcheckpoint.latest_step(straight) == 4
    _assert_states_close(tcheckpoint._load(part, 4),
                         tcheckpoint._load(straight, 4))


def test_sigterm_to_one_rank_stops_every_rank_at_one_step(tmp_path):
    ckpt_dir = str(tmp_path / "ckpt")
    cfg = dict(COMMON, mesh={"data": 2}, steps=400, checkpoint_dir=ckpt_dir,
               checkpoint_every=1000)
    outs = [open(tmp_path / f"out{i}", "w+") for i in range(2)]
    port = launch.free_port()
    procs = [subprocess.Popen(LOOP + [json.dumps(cfg)], cwd=ROOT,
                              env=launch.gang_env(2, i, port, _env()),
                              stdout=outs[i], stderr=subprocess.DEVNULL,
                              text=True) for i in range(2)]
    try:
        deadline = time.monotonic() + GANG_TIMEOUT_S
        while "step=3 " not in open(tmp_path / "out0").read():
            assert time.monotonic() < deadline and procs[0].poll() is None
            time.sleep(0.1)
        procs[1].send_signal(signal.SIGTERM)
        for p in procs:
            p.wait(max(deadline - time.monotonic(), 1.0))
    finally:
        launch.stop(procs)
    results = []
    for i, p in enumerate(procs):
        assert p.returncode == 0, i
        outs[i].seek(0)
        results.append(json.loads(outs[i].read().strip().splitlines()[-1]))
    steps = {r["step"] for r in results}
    assert all(r["preempted"] for r in results) and len(steps) == 1
    assert 3 <= steps.pop() == tcheckpoint.latest_step(ckpt_dir) < 400


@pytest.mark.parametrize("model,extra", [
    # The transformer trains over sequence (tests/test_torch_pipeline.py);
    # BERT does not yet.
    ("bert-test-tiny", {"mesh": {"data": 1, "sequence": 2}}),
], ids=["sequence2"])
def test_unported_gangs_refuse_before_any_step(model, extra):
    cfg = dict(model=model, batch_size=2, seq_len=8, steps=2, log_every=1,
               device="cpu", **extra)
    procs = _gang(LOOP + [json.dumps(cfg)], 2)
    for p in procs:
        assert p.returncode != 0
        assert "not yet ported" in p.stderr
        assert "step=" not in p.stdout


def _served_job(annotations=None):
    """JAX's fake apiserver over HTTP holding the JaxJob ``ej`` in
    ``default``; the caller shuts it down."""
    from kubeflow_tpu.apis import jobs as jobs_api
    from kubeflow_tpu.k8s.fake import FakeApiServer
    from kubeflow_tpu.k8s.httpfake import serve

    fake = FakeApiServer()
    fake.ensure_namespace("default")
    for crd in jobs_api.all_job_crds():
        fake.create(crd)
    fake.create({
        "apiVersion": jobs_api.JOBS_API_VERSION, "kind": "JaxJob",
        "metadata": {"name": "ej", "namespace": "default",
                     "annotations": annotations or {}},
        "spec": {"replicaSpecs": {"Worker": {
            "replicas": 1, "template": {"spec": {"containers": [
                {"name": "main", "image": "i"}]}}}}}})
    httpd, port = serve(fake)
    return fake, httpd, f"http://127.0.0.1:{port}"


def test_elastic_gang_starts_on_its_grant():
    """``elastic_poll_steps`` in a gang of two started as a user starts it:
    the job's grant (1 of 2 hosts, read over HTTP from the apiserver the
    environment names) makes the first mesh one rank; rank 1 stays in the
    loop outside it and both return the same result."""
    from kubeflow_tpu.apis import scheduling as sched_api

    fake, httpd, host = _served_job({
        sched_api.ANN_PLACEMENT: sched_api.encode_placement(
            "gpu", "1x2", "s0", ["h0"], "t0",
            elastic={"granted": 1, "min": 1, "max": 2})})
    cfg = dict(model="lm-test-tiny", batch_size=2, seq_len=8, steps=2,
               log_every=1, device="cpu", mesh={"data": 2},
               elastic_poll_steps=5)
    try:
        procs = _ok(_gang(LOOP + [json.dumps(cfg)], 2,
                          KUBEFLOW_TPU_JOB_NAME="ej",
                          KUBEFLOW_TPU_APISERVER=host))
    finally:
        httpd.shutdown()
    results = [_result(p) for p in procs]
    for r in results:
        assert r["devices"] == 1 and r["reshard_count"] == 0
        assert r["step"] == 2 and r["loss"] == results[0]["loss"]
    assert sum(line.startswith("step=")
               for line in procs[0].stdout.splitlines()) == 2


def test_allreduce_workloads_at_two_ranks():
    value = 2.5
    smoke = _ok(_gang([sys.executable, "-m",
                       "kubeflow_tpu_torch.workloads.allreduce_smoke",
                       "--device", "cpu", "--value", str(value),
                       "--alsologtostderr", "-v=1"], 2))
    for i, p in enumerate(smoke):
        r = _result(p)
        assert r == {"process_id": i, "num_processes": 2, "local_devices": 1,
                     "global_devices": 2, "psum": 2 * value,
                     "expected": 2 * value, "ok": True}
    bench = _ok(_gang([sys.executable, "-m",
                       "kubeflow_tpu_torch.workloads.allreduce_bench",
                       "--device", "cpu", "--min-elems", "1024",
                       "--max-elems", "16384", "--iters", "3"], 2))
    lines = [json.loads(line) for line in bench[0].stdout.splitlines()
             if line.startswith("{")]
    sizes, summary = lines[:-1], lines[-1]
    assert [s["elements"] for s in sizes] == [1024, 4096, 16384]
    for s in sizes:  # the ring formula, 2(n-1)/n x bytes / s
        assert s["devices"] == 2 and s["bytes"] == 4 * s["elements"]
        np.testing.assert_allclose(
            s["algo_bandwidth_gbps"],
            s["bytes"] / s["seconds_per_allreduce"] / 1e9, rtol=1e-9)
    assert summary == {"metric": "allreduce_peak_bandwidth", "unit": "GB/s",
                       "devices": 2, "value": max(
                           s["algo_bandwidth_gbps"] for s in sizes)}
    assert "kubeflow-tpu-metrics" in bench[0].stdout
    assert bench[1].stdout.strip() == ""  # only process 0 prints


def test_allreduce_bench_publishes_the_job_status():
    """With the job's environment the benchmark writes its peak into the
    job's status.metrics (its apiserver client pointed at JAX's fake
    apiserver over HTTP)."""
    fake, httpd, host = _served_job()
    code = ("import sys; from kubeflow_tpu_torch import k8s_client; "
            f"k8s_client.ClusterConfig.__init__.__defaults__ = ({host!r}, "
            "None, True); from kubeflow_tpu_torch.workloads import "
            "allreduce_bench; sys.exit(allreduce_bench.main(sys.argv[1:]))")
    try:
        proc = subprocess.run(
            [sys.executable, "-c", code, "--device", "cpu", "--max-elems",
             "1024", "--iters", "1"],
            cwd=ROOT, env=_env(KUBEFLOW_TPU_JOB_NAME="ej"),
            capture_output=True, text=True, timeout=GANG_TIMEOUT_S)
    finally:
        httpd.shutdown()
    assert proc.returncode == 0, proc.stderr[-3000:]
    summary = json.loads([line for line in proc.stdout.splitlines()
                          if line.startswith("{")][-1])
    assert summary["metric"] == "allreduce_peak_bandwidth"
    job = fake.get("kubeflow-tpu.org/v1", "JaxJob", "ej", "default")
    assert job["status"]["metrics"] == {
        "allreduce_peak_gbps": summary["value"]}
    assert "publish failed" not in proc.stdout


def test_ddp_workload_at_two_ranks():
    port = launch.free_port()
    cmd = [sys.executable, "-m", "kubeflow_tpu_torch.workloads.torch_xla_ddp",
           "--device", "cpu", "--steps", "4", "--log-every", "2",
           "--batch-size", "8"]
    procs = [subprocess.Popen(cmd, cwd=ROOT, env=_env(
        MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE="2",
        RANK=str(i)), stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
        text=True) for i in range(2)]
    try:
        outs = [p.communicate(timeout=GANG_TIMEOUT_S)[0] for p in procs]
    finally:
        launch.stop(procs)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0
        r = json.loads(out.strip().splitlines()[-1])
        assert r["rank"] == i and r["world_size"] == 2 and r["steps"] == 4
        assert np.isfinite(r["loss"])
    assert "step=2 loss=" in outs[0] and "step=" not in outs[1]


@pytest.mark.parametrize("module", ["allreduce_smoke", "allreduce_bench",
                                    "torch_xla_ddp", "tf_cnn"])
def test_workloads_raise_without_cuda_unless_asked_for_the_cpu(module):
    """The workloads run on CUDA by default; on a host without it they
    raise (no silent move to the CPU) unless ``--device cpu`` is given."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    proc = subprocess.run(
        [sys.executable, "-m", f"kubeflow_tpu_torch.workloads.{module}"],
        cwd=ROOT, env=_env(), capture_output=True, text=True,
        timeout=GANG_TIMEOUT_S)
    assert proc.returncode != 0 and "CUDA is not available" in proc.stderr
