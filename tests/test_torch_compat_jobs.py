"""The MPI, MXNet and Chainer jobs over the port against the JAX package's.

- ``workloads/mpi_launcher.py``: its hostfile parsing and writing, the
  worker wait, the mpirun line and ``main`` (single-process mode and the
  dry run) give what JAX's give on the same inputs; the port's one
  option, ``--single-process-arg``, reaches the command in single-process
  mode only.
- ``gpu-mxnet-job`` and ``gpu-chainer-job`` rendered with the compat
  workloads' commands, their pods written by the port's job controller on
  the port's fake apiserver, each pod's command run as a process with
  the pod's environment (its addresses mapped to 127.0.0.1 and a free
  port): the port's ``mxnet_ps`` and ``chainermn_train`` and JAX's, run
  from the same environment, give the same reports. The Chainer ranks'
  losses are the same from the same seeds (to 1e-9: the master sums the
  workers' gradients in their arrival order), and every port rank ends on
  one model (``model_digest``). MXNet workers push to shared servers in
  an order the run does not fix, so a gang of two workers and two
  servers has its reports held equal but for the losses, and every
  worker converges; a gang of one worker and one server, whose order is
  fixed, has its losses held to JAX's to 1e-9. The job reaches
  Succeeded.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

import kubeflow_tpu.workloads.mpi_launcher as jml
import kubeflow_tpu_torch.workloads.mpi_launcher as tml
from kubeflow_tpu_torch.apis import jobs as jobs_api
from kubeflow_tpu_torch.k8s_fake import FakeApiServer
from kubeflow_tpu_torch.manifests import generate
from kubeflow_tpu_torch.operators.jobs import JobController

ROOT = Path(__file__).resolve().parent.parent
HOSTFILES = [
    "w0.job.ns slots=4\nw1.job.ns slots=4\n# comment\n",
    "a slots=1",
    "\n  b  \n# x\nc slots=2 max_slots=8\n",
    "",
]
STEPS = 12
PROC_TIMEOUT_S = 15


@pytest.mark.parametrize("content", HOSTFILES)
def test_hostfile_parse_and_write_equal_jax(content, tmp_path):
    assert tml.parse_hostfile(content) == jml.parse_hostfile(content)
    got = tml.write_hostfile(content, str(tmp_path / "t" / "hostfile"))
    want = jml.write_hostfile(content, str(tmp_path / "j" / "hostfile"))
    assert got == want
    assert ((tmp_path / "t" / "hostfile").read_text()
            == (tmp_path / "j" / "hostfile").read_text())


def _wait_calls(mod) -> tuple[list, list]:
    resolved, calls, logs = {"w0"}, [], []

    def resolve(host):
        calls.append(host)
        if host not in resolved:
            resolved.add(host)  # appears on the next poll
            raise OSError("not yet")
        return "10.0.0.1"

    mod.wait_for_workers(["w0", "w1", "w2"], timeout=10, poll=0.001,
                         resolve=resolve, log=logs.append)
    with pytest.raises(TimeoutError) as e:
        mod.wait_for_workers(["never"], timeout=0, poll=0.001,
                             resolve=lambda h: (_ for _ in ()).throw(
                                 OSError(h)), log=logs.append)
    return calls, logs + [str(e.value)]


def test_worker_wait_equals_jax():
    assert _wait_calls(tml) == _wait_calls(jml)


@pytest.mark.parametrize("entries,mpirun", [
    ([("w0", 4), ("w1", 4)], "/usr/bin/mpirun"),
    ([("w0", 1)], "/opt/mpi/bin/mpirun"),
    ([], "/usr/bin/mpirun"),
    ([("w0", 2)], ""),
])
def test_mpirun_line_equals_jax(entries, mpirun):
    cmd = ["python", "-m", "kubeflow_tpu_torch.workloads.allreduce_bench"]
    assert (tml.build_command(cmd, "/etc/mpi/hostfile", entries,
                              mpirun=mpirun)
            == jml.build_command(cmd, "/etc/mpi/hostfile", entries,
                                 mpirun=mpirun))


@pytest.mark.parametrize("content", ["", "localhost slots=1\n"])
def test_launcher_main_equals_jax(content, tmp_path, monkeypatch, capsys):
    """``main`` in single-process mode (no mpirun: the command itself)
    and as a dry run with mpirun found print and run the same."""
    out = {}
    for name, mod in (("jax", jml), ("torch", tml)):
        hostfile = str(tmp_path / name / "hostfile")
        monkeypatch.setenv(mod.ENV_HOSTFILE_CONTENT, content)
        monkeypatch.setattr(mod.shutil, "which", lambda _: None)
        monkeypatch.setattr(mod.socket, "gethostbyname", lambda h: h)
        ran = []
        monkeypatch.setattr(mod.subprocess, "call",
                            lambda cmd: ran.append(cmd) or 0)
        rc = mod.main(["--hostfile", hostfile, "--", "echo", "ok"])
        monkeypatch.setattr(mod.shutil, "which", lambda _: "/usr/bin/mpirun")
        dry = mod.main(["--hostfile", hostfile, "--dry-run", "--",
                        "echo", "ok"])
        printed = capsys.readouterr().out.replace(hostfile, "<hostfile>")
        out[name] = (rc, ran, dry, printed)
    assert out["torch"] == out["jax"]
    assert out["torch"][1] == [["echo", "ok"]]


@pytest.mark.parametrize("content", ["", "localhost slots=1\n"])
def test_launcher_single_process_arg_only_without_mpirun(content, tmp_path,
                                                          monkeypatch,
                                                          capsys):
    """``--single-process-arg`` is appended to the command run here
    (no mpirun, or no workers); mpirun's line is JAX's, without it."""
    hostfile = str(tmp_path / "hostfile")
    monkeypatch.setenv(tml.ENV_HOSTFILE_CONTENT, content)
    monkeypatch.setattr(tml.socket, "gethostbyname", lambda h: h)
    ran = []
    monkeypatch.setattr(tml.subprocess, "call",
                        lambda cmd: ran.append(cmd) or 0)
    monkeypatch.setattr(tml.shutil, "which", lambda _: None)
    flag = "--single-process-arg=--device=cpu"
    assert tml.main(["--hostfile", hostfile, flag, "--", "echo", "ok"]) == 0
    assert ran == [["echo", "ok", "--device=cpu"]]
    monkeypatch.setattr(tml.shutil, "which", lambda _: "/usr/bin/mpirun")
    tml.main(["--hostfile", hostfile, "--dry-run", flag, "--", "echo",
              "ok"])
    entries = tml.parse_hostfile(content)
    want = jml.build_command(["echo", "ok"], hostfile, entries,
                             mpirun="/usr/bin/mpirun")
    if want == ["echo", "ok"]:  # no workers: single-process mode
        want.append("--device=cpu")
    assert capsys.readouterr().out.strip().splitlines()[-1] == " ".join(
        want)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _pods_of(kind: str, objs: list[dict]):
    """The pods the port's job controller writes for the rendered job."""
    api = FakeApiServer()
    api.ensure_namespace("kubeflow")
    for crd in jobs_api.all_job_crds():
        api.apply(crd)
    (job,) = objs
    jobs_api.validate_job(job)
    api.create(job)
    ctrl = JobController(api, kind)
    ctrl.reconcile_all()
    pods = api.list("v1", "Pod", "kubeflow")
    assert len(pods) == sum(r["replicas"]
                            for r in job["spec"]["replicaSpecs"].values())
    return api, ctrl, pods


def _local_env(pod: dict, port: int) -> dict:
    """The pod's env on this host: every job address 127.0.0.1, the
    rendezvous port a free one."""
    (c,) = pod["spec"]["containers"]
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("DMLC_", "CHAINERMN_"))}
    env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    for e in c["env"]:
        value = e["value"]
        if e["name"] in ("DMLC_PS_ROOT_URI", "CHAINERMN_MASTER_ADDR"):
            value = "127.0.0.1"
        elif e["name"] in ("DMLC_PS_ROOT_PORT", "CHAINERMN_MASTER_PORT"):
            value = str(port)
        env[e["name"]] = value
    return env


def _run_gang(pods: list[dict], package: str) -> list[dict]:
    """Each pod's command (``python -m <package>.workloads...``) run with
    its local env, all at once; each process's last line parsed."""
    port = _free_port()
    procs = []
    for pod in pods:
        (c,) = pod["spec"]["containers"]
        cmd = list(c["command"])
        assert cmd[:2] == ["python", "-m"]
        cmd[0] = sys.executable
        cmd[2] = cmd[2].replace("kubeflow_tpu_torch.", f"{package}.")
        procs.append(subprocess.Popen(
            cmd, cwd=ROOT, env=_local_env(pod, port),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    reports = []
    try:
        for proc in procs:
            out, err = proc.communicate(timeout=PROC_TIMEOUT_S)
            assert proc.returncode == 0, err[-2000:]
            reports.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return reports


def _succeed(api, ctrl, kind: str) -> dict:
    for pod in api.list("v1", "Pod", "kubeflow"):
        pod["status"] = {"phase": "Succeeded"}
        api.update_status(pod)
    ctrl.reconcile_all()
    job = api.get(jobs_api.JOBS_API_VERSION, kind, "compat", "kubeflow")
    return job["status"]


def test_mxnet_gang_through_the_port_controller_equals_jax():
    command = ["python", "-m", "kubeflow_tpu_torch.workloads.mxnet_ps",
               "--steps", str(STEPS)]
    objs = generate("gpu-mxnet-job", {
        "name": "compat", "num_workers": 2, "num_servers": 2,
        "gpus_per_worker": 1, "command": command})
    api, ctrl, pods = _pods_of("MXNetJob", objs)
    envs = [{e["name"]: e["value"]
             for e in p["spec"]["containers"][0]["env"]} for p in pods]
    assert sorted(e["DMLC_ROLE"] for e in envs) == [
        "scheduler", "server", "server", "worker", "worker"]
    assert {e["DMLC_PS_ROOT_URI"] for e in envs} == {
        "compat-scheduler-0.compat.kubeflow"}

    def keyed(reports):
        return sorted(({k: v for k, v in r.items()
                        if k not in ("first_loss", "final_loss")}
                       for r in reports),
                      key=lambda r: (r["role"], r.get("id", 0)))

    got = _run_gang(pods, "kubeflow_tpu_torch")
    want = _run_gang(pods, "kubeflow_tpu")
    assert keyed(got) == keyed(want)
    workers = [r for r in got if r["role"] == "worker"]
    assert len(workers) == 2 and all(w["converged"] for w in workers)
    assert sorted(r["pushes"] for r in got if r["role"] == "server") == [
        2 * STEPS, 2 * STEPS]
    assert [r["workers_finalized"] for r in got
            if r["role"] == "scheduler"] == [2]
    assert _succeed(api, ctrl, "MXNetJob")["state"] == "Succeeded"


def test_mxnet_one_server_one_worker_losses_equal_jax():
    """One worker pushing to one server: the order is fixed, so the
    port's reports, losses included, are JAX's from the same seed."""
    command = ["python", "-m", "kubeflow_tpu_torch.workloads.mxnet_ps",
               "--steps", str(STEPS)]
    objs = generate("gpu-mxnet-job", {
        "name": "compat", "num_workers": 1, "num_servers": 1,
        "gpus_per_worker": 1, "command": command})
    api, ctrl, pods = _pods_of("MXNetJob", objs)

    def keyed(reports):
        return sorted(reports, key=lambda r: r["role"])

    got = keyed(_run_gang(pods, "kubeflow_tpu_torch"))
    want = keyed(_run_gang(pods, "kubeflow_tpu"))
    assert [r["role"] for r in got] == ["scheduler", "server", "worker"]
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for key in g:
            if key in ("first_loss", "final_loss"):
                assert g[key] == pytest.approx(w[key], rel=1e-9, abs=0)
            else:
                assert g[key] == w[key]
    (worker,) = [r for r in got if r["role"] == "worker"]
    assert worker["converged"] and worker["final_loss"] < worker[
        "first_loss"]
    assert _succeed(api, ctrl, "MXNetJob")["state"] == "Succeeded"


def test_chainer_gang_through_the_port_controller_equals_jax():
    command = ["python", "-m",
               "kubeflow_tpu_torch.workloads.chainermn_train",
               "--steps", str(STEPS)]
    objs = generate("gpu-chainer-job", {
        "name": "compat", "num_workers": 2, "gpus_per_worker": 1,
        "command": command})
    api, ctrl, pods = _pods_of("ChainerJob", objs)
    got = sorted(_run_gang(pods, "kubeflow_tpu_torch"),
                 key=lambda r: r["rank"])
    want = sorted(_run_gang(pods, "kubeflow_tpu"), key=lambda r: r["rank"])
    assert [r["rank"] for r in got] == [0, 1, 2]
    assert len({r["model_digest"] for r in got}) == 1
    for g, w in zip(got, want):
        assert {k: v for k, v in g.items() if k != "model_digest"}.keys() \
            == w.keys()
        for key in ("rank", "num_processes", "steps", "converged"):
            assert g[key] == w[key]
        for key in ("first_loss", "final_loss"):
            assert g[key] == pytest.approx(w[key], rel=1e-9, abs=0)
        assert g["num_processes"] == 3 and g["converged"]
    assert _succeed(api, ctrl, "ChainerJob")["state"] == "Succeeded"
