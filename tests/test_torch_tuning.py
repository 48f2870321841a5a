"""The port's tuning stack against the JAX package's.

- The suggestion algorithms (a copy): every policy proposes JAX's
  assignments at several seeds over the same observation history.
- The sweep CLI: ``python -m kubeflow_tpu_torch.tuning.sweep --scenario
  synthetic-knobs --policies random,tpe --trials 12 --seed 7 --promote``
  prints JAX's record (``synthetic-knobs`` is closed-form), apart from the
  promotion's wall-clock stamp ``at``.
- The Experiment controller: on a deterministic runner its status equals
  JAX's controller's, trial for trial (seeds, assignments, objectives,
  best, promotion); on ``decode-tps`` through the port's decoder at
  ``lm-test-tiny`` on the CPU, three trials end Succeeded with JAX's
  trial seeds and assignments. Job mode renders a trial JaxJob equal to
  JAX's under the mapping of ``test_torch_manifests.py`` (the port's
  image with one ``nvidia.com/gpu``, the port's trial CLI in place of
  ``bench_serving.py``), and the CLI in that command runs.
- ``python -m kubeflow_tpu_torch.operators --once`` reconciles an
  Experiment against JAX's fake apiserver served over HTTP.
"""

import copy
import functools
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from kubeflow_tpu.apis.experiment import experiment as jexperiment  # noqa: E402
from kubeflow_tpu.apis.experiment import experiment_crd as jexperiment_crd  # noqa: E402
from kubeflow_tpu.apis.inference import inference_service as jinference_service  # noqa: E402
from kubeflow_tpu.apis.inference import inference_service_crd as jinference_crd  # noqa: E402
from kubeflow_tpu.k8s.fake import FakeApiServer as JFakeApiServer  # noqa: E402
from kubeflow_tpu.k8s.httpfake import serve  # noqa: E402
from kubeflow_tpu.operators.experiment import ExperimentController as JController  # noqa: E402
from kubeflow_tpu.tuning import suggestions as jsug  # noqa: E402
from kubeflow_tpu_torch.apis.experiment import experiment, experiment_crd  # noqa: E402
from kubeflow_tpu_torch.apis.inference import (  # noqa: E402
    inference_service,
    inference_service_crd,
)
from kubeflow_tpu_torch.k8s_fake import FakeApiServer  # noqa: E402
from kubeflow_tpu_torch.manifests import images  # noqa: E402
from kubeflow_tpu_torch.operators.experiment import ExperimentController  # noqa: E402
from kubeflow_tpu_torch.serving import scenarios  # noqa: E402
from kubeflow_tpu_torch.tuning import suggestions as tsug  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
EXP = "kubeflow-tpu.org/v1"

SPACES = {
    "decode-tps": scenarios.DECODE_TPS_PARAMETERS,
    "mixed": [
        {"name": "lr", "parameterType": "double",
         "feasibleSpace": {"min": 1e-4, "max": 1e-1, "logScale": True}},
        {"name": "width", "parameterType": "int",
         "feasibleSpace": {"min": 1, "max": 9}},
        {"name": "opt", "parameterType": "categorical",
         "feasibleSpace": {"list": ["sgd", "adam", "adafactor"]}},
        {"name": "momentum", "parameterType": "double",
         "feasibleSpace": {"min": 0.0, "max": 0.99}},
    ],
}


def _objective(assignments: dict) -> float:
    """A deterministic objective of an assignment (no trial runs)."""
    total = 0.0
    for k, v in sorted(assignments.items()):
        x = float(len(v)) if isinstance(v, str) else float(v)
        total += np.sin(x * (1 + len(k))) + 0.1 * x
    return round(total, 9)


@pytest.mark.parametrize("policy", ["random", "grid", "hyperband",
                                    "bayesianoptimization", "tpe"])
@pytest.mark.parametrize("space", list(SPACES))
def test_suggestions_propose_as_jax(policy, space):
    for seed in (0, 7, 123):
        jalgo = jsug.get_algorithm(
            policy, jsug.domains_from_spec(SPACES[space]), seed=seed)
        talgo = tsug.get_algorithm(
            policy, tsug.domains_from_spec(SPACES[space]), seed=seed)
        jobs, tobs = [], []
        for _ in range(14):
            want = jalgo.next(jobs)
            got = talgo.next(tobs)
            assert got == want, (seed, len(jobs))
            if want is None:
                break
            jobs.append(jsug.Observation(want, _objective(want)))
            tobs.append(tsug.Observation(got, _objective(got)))
    curve = [(i, float(i % 3)) for i in range(6)]
    done = [[(i, 2.0 + j) for i in range(6)] for j in range(3)]
    assert (tsug.MedianEarlyStop(min_trials=3).should_stop(curve, done)
            == jsug.MedianEarlyStop(min_trials=3).should_stop(curve, done))


SWEEP_ARGS = ["--scenario", "synthetic-knobs", "--policies", "random,tpe",
              "--trials", "12", "--seed", "7", "--promote"]


def _record(stdout: str) -> dict:
    record = json.loads(stdout)
    for result in record["policies"].values():
        result["promotion"].pop("at")  # the wall clock at promotion
    return record


def test_sweep_record_equals_jax(capsys):
    proc = subprocess.run(
        [sys.executable, "-m", "kubeflow_tpu_torch.tuning.sweep",
         *SWEEP_ARGS], cwd=ROOT, capture_output=True, text=True,
        timeout=180)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    got = _record(proc.stdout)
    # JAX's CLI, in this process (its main with the same argv).
    from kubeflow_tpu.tuning.sweep import main as jmain

    capsys.readouterr()
    assert jmain(SWEEP_ARGS) == 0
    assert got == _record(capsys.readouterr().out)
    assert not got["regression"]
    assert got["policies"]["tpe"]["promotedVersions"][1]["engine"]


def _stub_trial(scenario, assignments, *, seed, quick=True):
    value = _objective(assignments) + 0.001 * (seed % 7)
    return {"objectives": {"tokens_per_sec": value, "ttft_p99_s": 1.0},
            "config": f"stub seed{seed}"}


def _run(controller_cls, api, crd, svc_crd, svc, exp, runner, passes=10):
    api.ensure_namespace("kubeflow")
    api.apply(crd)
    api.apply(svc_crd)
    api.create(svc)
    api.create(exp)
    ctrl = controller_cls(api, run_trial=runner, clock=lambda: 1234.5)
    for _ in range(passes):
        ctrl.reconcile_all()
        status = api.get(EXP, "Experiment", exp["metadata"]["name"],
                         "kubeflow")["status"]
        if status.get("state") in ("Succeeded", "Failed"):
            break
    return status, api.get(EXP, "InferenceService", "target", "kubeflow")


@pytest.mark.parametrize("policy", ["tpe", "random", "grid"])
def test_controller_status_equals_jax_on_a_deterministic_runner(policy):
    kw = dict(algorithm=policy, max_trials=7, parallel_trials=2, seed=3,
              promotion={"target": "target", "minImprovementPercent": 0.0})
    want = _run(JController, JFakeApiServer(), jexperiment_crd(),
                jinference_crd(), jinference_service(
                    "target", "kubeflow", "lm-test-tiny"),
                jexperiment("e", "kubeflow", "decode-tps", **kw),
                _stub_trial)
    got = _run(ExperimentController, FakeApiServer(), experiment_crd(),
               inference_service_crd(), inference_service(
                   "target", "kubeflow", "lm-test-tiny"),
               experiment("e", "kubeflow", "decode-tps", **kw), _stub_trial)
    assert got[0] == want[0]
    assert got[0]["state"] == "Succeeded"
    assert got[1]["spec"] == want[1]["spec"]


def test_decode_tps_experiment_through_the_port_on_cpu():
    api = FakeApiServer()
    api.ensure_namespace("kubeflow")
    api.apply(experiment_crd())
    api.create(experiment("tps", "kubeflow", "decode-tps",
                          algorithm="random", max_trials=3,
                          parallel_trials=2, seed=7))
    ctrl = ExperimentController(api, run_trial=functools.partial(
        scenarios.run_trial, device="cpu"))
    for _ in range(4):
        ctrl.reconcile_all()
    status = api.get(EXP, "Experiment", "tps", "kubeflow")["status"]
    assert status["state"] == "Succeeded", status
    trials = status["trials"]
    assert [t["seed"] for t in trials] == [7 * 100_003 + i for i in range(3)]
    assert trials[0]["assignments"] == {
        **scenarios.get_scenario("decode-tps").defaults}
    for t in trials:
        assert t["state"] == "Succeeded"
        assert t["objectiveValue"] > 0
        assert t["objectives"]["kv_blocks_in_use_after_drain"] == 0
    # JAX's controller proposes the same trials (random ignores the
    # observed objectives).
    japi = JFakeApiServer()
    japi.ensure_namespace("kubeflow")
    japi.apply(jexperiment_crd())
    japi.create(jexperiment("tps", "kubeflow", "decode-tps",
                            algorithm="random", max_trials=3,
                            parallel_trials=2, seed=7))
    jctrl = JController(japi, run_trial=_stub_trial)
    for _ in range(4):
        jctrl.reconcile_all()
    jtrials = japi.get(EXP, "Experiment", "tps", "kubeflow")["status"][
        "trials"]
    assert [(t["seed"], t["assignments"]) for t in trials] == [
        (t["seed"], t["assignments"]) for t in jtrials]


def _job_mode(controller_cls, api, exp_fn):
    api.ensure_namespace("kubeflow")
    api.create(exp_fn("jm", "kubeflow", "decode-tps", algorithm="random",
                      max_trials=2, parallel_trials=1, seed=5,
                      trial_mode="job"))
    ctrl = controller_cls(api)
    ctrl.reconcile_all()
    (job,) = api.list("kubeflow-tpu.org/v1", "JaxJob", "kubeflow")
    return ctrl, job


def _trial_job_to_gpu(job: dict) -> dict:
    """JAX's trial JaxJob under the mapping: the port's image asking for
    one GPU, the port's trial CLI for bench_serving.py."""
    out = copy.deepcopy(job)
    (c,) = out["spec"]["replicaSpecs"]["Worker"]["template"]["spec"][
        "containers"]
    assert c["command"][:2] == ["python", "bench_serving.py"]
    c["command"][1:2] = ["-m", "kubeflow_tpu_torch.serving.scenarios"]
    c["image"] = images.TORCH_CUDA
    c["resources"] = images.gpu_resources(1)
    return out


def _volatile(job: dict) -> dict:
    out = copy.deepcopy(job)
    for k in ("uid", "resourceVersion", "creationTimestamp"):
        out["metadata"].pop(k, None)
    for ref in out["metadata"]["ownerReferences"]:
        ref.pop("uid")
    return out


def test_job_mode_trial_renders_jax_job_on_the_port():
    from kubeflow_tpu.apis import jobs as jobs_api

    japi = JFakeApiServer()
    japi.apply(jexperiment_crd())
    for crd in jobs_api.all_job_crds():
        japi.apply(crd)
    _, want = _job_mode(JController, japi, jexperiment)
    api = FakeApiServer()
    api.apply(experiment_crd())
    ctrl, got = _job_mode(ExperimentController, api, experiment)
    assert _volatile(got) == _volatile(_trial_job_to_gpu(want))

    # The trial's command runs the port's trial CLI (on the CPU here).
    (c,) = got["spec"]["replicaSpecs"]["Worker"]["template"]["spec"][
        "containers"]
    proc = subprocess.run([sys.executable, *c["command"][1:], "--device",
                           "cpu"], cwd=ROOT, capture_output=True, text=True,
                          timeout=180)
    assert proc.returncode == 0, proc.stderr
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    status = api.get(EXP, "Experiment", "jm", "kubeflow")["status"]
    assert result["seed"] == status["trials"][0]["seed"] == 5 * 100_003
    assert result["assignments"] == status["trials"][0]["assignments"]
    assert result["objectives"]["tokens_per_sec"] > 0

    # A preempted trial re-runs at its seed under a fresh job; a finished
    # job's status.metrics is the trial's objective.
    got["metadata"].setdefault("annotations", {})[
        "kubeflow-tpu.org/preempted-by"] = "other"
    api.update(got)
    ctrl.reconcile_all()
    (rerun,) = api.list("kubeflow-tpu.org/v1", "JaxJob", "kubeflow")
    assert rerun["metadata"]["name"] == "jm-trial-0-r1"
    rerun["status"] = {"state": "Succeeded",
                       "metrics": {"tokens_per_sec": 42.0}}
    api.update_status(rerun)
    ctrl.reconcile_all()
    status = api.get(EXP, "Experiment", "jm", "kubeflow")["status"]
    assert status["trials"][0]["objectiveValue"] == 42.0
    assert status["trials"][0]["retries"] == 1


def test_operator_manager_reconciles_over_http():
    from kubeflow_tpu.apis.experiment import experiment_crd as jcrd

    fake = JFakeApiServer()
    fake.ensure_namespace("kubeflow")
    fake.create(jcrd())
    fake.create(jexperiment("http-exp", "kubeflow", "synthetic-knobs",
                            algorithm="tpe", max_trials=3,
                            parallel_trials=3, seed=1))
    httpd, port = serve(fake)
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "kubeflow_tpu_torch.operators", "--once",
             "--device", "cpu", "--apiserver", f"http://127.0.0.1:{port}",
             "--alsologtostderr", "-v=1"],
            cwd=ROOT, capture_output=True, text=True, timeout=120)
    finally:
        httpd.shutdown()
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1])["reconciled"] == 1
    status = fake.get(EXP, "Experiment", "http-exp", "kubeflow")["status"]
    assert status["state"] == "Succeeded" and len(status["trials"]) == 3
