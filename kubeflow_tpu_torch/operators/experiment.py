"""ExperimentController: closed-loop knob search against serving SLOs;
the port's counterpart of ``kubeflow_tpu/operators/experiment.py``.

A copy of JAX's controller with three differences: the in-process trials
and the scenario lookup go through the port's registry
(``kubeflow_tpu_torch.serving.scenarios``), a job-mode trial is a JaxJob
on the port's image asking for one ``nvidia.com/gpu`` and running the
port's trial CLI (``python -m kubeflow_tpu_torch.serving.scenarios``),
and the imports are the port's copies. Trial seeds, trial 0 as the
defaults, early stop, preemption re-runs, promotion and the CRs it
writes are JAX's. As in JAX, the trial CLI prints its result and
publishes nothing to the job's status, so a job-mode trial reads no
objective from ``status.metrics`` unless something else writes it there.

Katib's experiment loop fused with kubebench's measured runs
(kubeflow/katib studyjobcontroller.libsonnet; kubebench job templates):
reconcile an Experiment by fanning out measured trials of a registered
bench_serving scenario (serving/scenarios.py), feeding each trial's
objective — read from the histogram exposition through the same
``scrape_signals`` vector the autoscaler consumes — back into the
suggestion algorithm, and shipping the winning knob config through the
rollout controller as a candidate version with SLO gates and
auto-rollback as the safety net.

Trial 0 is always the scenario's checked-in defaults: the experiment's
verdict is *improvement over the baseline*, recorded in status, not an
absolute number.

Two trial modes:

- ``inprocess`` (default, the fast path): the trial boots a throwaway
  ContinuousDecoder inside the operator process via the scenario
  registry — no cluster round-trip, used by CI and tests; on the card
  unless ``run_trial`` asks for the CPU;
- ``job``: the trial renders a **preemptible** JaxJob (low scheduler
  priority — trials are background load) running the same scenario via
  the trial CLI; a preempted trial is re-run with its recorded seed
  rather than poisoning the objective.

Reproducibility: one experiment seed (spec.seed) threads through both
suggestion sampling and scenario traffic generation; each trial's
derived seed is recorded in its status entry so a re-run observes the
same trace.
"""

from __future__ import annotations

import copy
import json
import logging
import os
import time

from kubeflow_tpu_torch.apis import API_GROUP, JOBS_API_VERSION
from kubeflow_tpu_torch.apis.experiment import (
    EXPERIMENT_API_VERSION,
    EXPERIMENT_KIND,
)
from kubeflow_tpu_torch.apis.inference import (
    INFERENCE_API_VERSION,
    INFERENCE_KIND,
    validate_versions,
)
from kubeflow_tpu_torch.k8s_client import retry_on_conflict
from kubeflow_tpu_torch.manifests import images
from kubeflow_tpu_torch.manifests import objects as k8s
from kubeflow_tpu_torch.operators.base import OPERATOR_METRICS, Controller
from kubeflow_tpu_torch.tuning.suggestions import (
    MedianEarlyStop,
    Observation,
    domains_from_spec,
    get_algorithm,
)

log = logging.getLogger(__name__)

LABEL_EXPERIMENT = "kubeflow-tpu.org/experiment-name"
LABEL_TRIAL = "kubeflow-tpu.org/trial-index"

# Background trials must lose every capacity fight: the scheduler
# preempts lowest-priority first, so trials sit well below the default.
TRIAL_PRIORITY = -100

# The scheduler's preemption annotation (kubeflow_tpu/apis/scheduling.py).
ANN_PREEMPTED_BY = f"{API_GROUP}/preempted-by"

# Bounded-cardinality experiment metrics (satellite): trial states are a
# closed enum, policies are the _ALGORITHMS registry, and the best-
# objective gauge is labeled by scenario (a small fixed registry) — no
# per-experiment or per-trial label anywhere.
_M_TRIALS = OPERATOR_METRICS.counter(
    "experiment_trials_total",
    "Experiment trials by terminal state", labels=("state",))
_M_BEST = OPERATOR_METRICS.gauge(
    "experiment_best_objective",
    "Best objective value observed, by scenario", labels=("scenario",))
_M_SUGGEST = OPERATOR_METRICS.counter(
    "tuning_suggestions_total",
    "Assignments proposed, by suggestion policy", labels=("policy",))

_TERMINAL = ("Succeeded", "Failed")


def _default_run_trial(scenario: str, assignments: dict, *, seed: int,
                       quick: bool = True, device: str = "cuda") -> dict:
    # Imported lazily: the scenario registry pulls in the serving engine
    # (and torch with it), which job-mode-only deployments never need.
    from kubeflow_tpu_torch.serving import scenarios
    return scenarios.run_trial(scenario, assignments, seed=seed,
                               quick=quick, device=device)


class ExperimentController(Controller):
    """Experiment CRD → measured trials → best config → rollout.

    Injectables (tests and CI drive all three):

    - ``run_trial(scenario, assignments, *, seed, quick)`` → trial
      result dict (default: the in-process scenario registry);
    - ``profile_dir`` → directory where per-trial BENCH-style profiles
      are written for ThroughputBook ingestion (default: off);
    - ``clock`` → wall-clock seconds for status timestamps.
    """

    api_version = EXPERIMENT_API_VERSION
    kind = EXPERIMENT_KIND
    resync_seconds = 10.0

    def __init__(self, client, *, run_trial=None, profile_dir=None,
                 clock=time.time):
        super().__init__(client)
        self.run_trial = run_trial or _default_run_trial
        self.profile_dir = profile_dir
        self.clock = clock

    # -- reconcile ------------------------------------------------------

    def reconcile(self, exp: dict) -> float | None:
        exp = copy.deepcopy(exp)
        spec = exp["spec"]
        status = exp.setdefault("status", {})
        if status.get("state") in _TERMINAL:
            return None

        try:
            scenario, parameters = self._resolve_scenario(spec)
        except Exception as e:
            status["state"] = "Failed"
            status["reason"] = str(e)
            self._push_status(exp)
            return None

        status.setdefault("state", "Running")
        seed = int(spec.get("seed", 0))
        status["seed"] = seed
        trials = status.setdefault("trials", [])

        objective = spec.get("objective", {})
        metric = objective.get("objectiveMetricName",
                               scenario_objective(scenario))
        maximize = objective.get(
            "type", scenario_optimization(scenario)) == "maximize"

        mode = spec.get("trialMode", "inprocess")
        if mode == "job":
            self._collect_job_trials(exp, trials, metric, spec)

        finished = [t for t in trials if t["state"] in _TERMINAL]
        succeeded = [t for t in finished if t["state"] == "Succeeded"
                     and t.get("objectiveValue") is not None]
        failed = [t for t in finished if t["state"] == "Failed"]

        self._update_best(spec, status, succeeded, maximize)

        goal = objective.get("goal")
        best = status.get("bestObjectiveValue")
        goal_met = (goal is not None and best is not None
                    and (best >= goal if maximize else best <= goal))
        max_trials = int(spec.get("maxTrialCount", 12))
        if len(failed) > int(spec.get("maxFailedTrialCount", 3)):
            status["state"] = "Failed"
            status["reason"] = f"{len(failed)} trials failed"
        elif goal_met or len(finished) >= max_trials:
            active = [t for t in trials if t["state"] not in _TERMINAL]
            if not active:
                status["state"] = "Succeeded"
                self._promote(exp, spec, status)
        else:
            self._spawn_trials(exp, spec, scenario, parameters, trials,
                               maximize, metric, mode)
            finished = [t for t in trials if t["state"] in _TERMINAL]
            succeeded = [t for t in finished if t["state"] == "Succeeded"
                         and t.get("objectiveValue") is not None]
            self._update_best(spec, status, succeeded, maximize)
            if (len(finished) >= max_trials
                    and not [t for t in trials
                             if t["state"] not in _TERMINAL]):
                status["state"] = "Succeeded"
                self._promote(exp, spec, status)

        status["completedTrialCount"] = len(
            [t for t in trials if t["state"] in _TERMINAL])
        self._push_status(exp)
        return 1.0 if status["state"] == "Running" else None

    # -- scenario plumbing ------------------------------------------------

    @staticmethod
    def _resolve_scenario(spec: dict):
        """(scenario object | None, parameter list). An explicit
        spec.parameters list wins; otherwise the scenario's registered
        space. A spec naming an unknown scenario fails the experiment."""
        from kubeflow_tpu_torch.serving import scenarios
        sc = scenarios.get_scenario(spec["scenario"])
        if sc.trial is None:
            raise ValueError(
                f"scenario {spec['scenario']!r} has no trial runner")
        parameters = spec.get("parameters") or list(sc.parameters)
        if not parameters:
            raise ValueError(
                f"scenario {spec['scenario']!r} declares no parameters")
        return sc, parameters

    @staticmethod
    def _trial_seed(seed: int, index: int) -> int:
        """Per-trial seed derived from the ONE experiment seed — stable
        across re-runs (a preempted trial re-observes the same trace)."""
        return seed * 100_003 + index

    # -- trial execution --------------------------------------------------

    def _spawn_trials(self, exp: dict, spec: dict, scenario,
                      parameters: list[dict], trials: list[dict],
                      maximize: bool, metric: str, mode: str) -> None:
        active = [t for t in trials if t["state"] not in _TERMINAL]
        budget = min(
            int(spec.get("parallelTrialCount", 2)) - len(active),
            int(spec.get("maxTrialCount", 12)) - len(trials),
        )
        if budget <= 0:
            return
        seed = int(spec.get("seed", 0))
        domains = domains_from_spec(parameters)
        policy = spec.get("algorithm", "tpe")
        # The proposer's stream is keyed off the experiment seed plus the
        # spawn point, so a controller restart replays identical
        # proposals for the same observation history.
        algo = get_algorithm(policy, domains, seed=seed * 1000 + len(trials))
        observations = [
            Observation(
                t["assignments"],
                t["objectiveValue"] if maximize else -t["objectiveValue"])
            for t in trials
            if t["state"] == "Succeeded"
            and t.get("objectiveValue") is not None
        ]
        defaults = dict(getattr(scenario, "defaults", {}) or {})
        for _ in range(budget):
            index = len(trials)
            if index == 0:
                # Baseline: the checked-in defaults, RECORDED as full
                # assignments so the proposers can place it on the unit
                # cube (a knob without a registered default sits at the
                # middle of its range).
                assignments: dict | None = {
                    d.name: defaults.get(d.name, d.from_unit(0.5))
                    for d in domains}
            else:
                assignments = algo.next(observations)
                _M_SUGGEST.labels(policy).inc()
            if assignments is None:  # space exhausted (grid)
                if not [t for t in trials if t["state"] not in _TERMINAL]:
                    exp["status"]["state"] = "Succeeded"
                    self._promote(exp, spec, exp["status"])
                return
            trial = {
                "index": index,
                "assignments": assignments,
                "seed": self._trial_seed(seed, index),
                "state": "Running",
                "mode": mode,
                "retries": 0,
            }
            trials.append(trial)
            if mode == "job":
                self._create_trial_job(exp, trial)
            else:
                self._run_inprocess(exp, spec, trial, metric)
                if trial["state"] == "Succeeded":
                    observations.append(Observation(
                        trial["assignments"],
                        trial["objectiveValue"] if maximize
                        else -trial["objectiveValue"]))

    def _run_inprocess(self, exp: dict, spec: dict, trial: dict,
                       metric: str) -> None:
        try:
            result = self.run_trial(
                spec["scenario"], dict(trial["assignments"]),
                seed=int(trial["seed"]), quick=True)
            value = result["objectives"][metric]
        except Exception as e:
            log.warning("experiment %s trial %d failed: %s",
                        exp["metadata"]["name"], trial["index"], e)
            trial["state"] = "Failed"
            trial["reason"] = str(e)
            _M_TRIALS.labels("failed").inc()
            return
        trial["state"] = "Succeeded"
        trial["objectiveValue"] = float(value)
        trial["objectives"] = {
            k: v for k, v in result["objectives"].items()
            if isinstance(v, (int, float))}
        trial["config"] = result.get("config", "")
        _M_TRIALS.labels("succeeded").inc()
        self._write_profile(exp, trial, result)

    def _write_profile(self, exp: dict, trial: dict, result: dict) -> None:
        """Per-trial BENCH-style profile: the exact shape
        ThroughputBook.from_bench_files ingests ({"parsed": {config,
        tokens_per_sec_per_chip, ...}}), so tuner measurements become
        scheduler capacity knowledge."""
        if not self.profile_dir:
            return
        path = os.path.join(
            self.profile_dir,
            f"BENCH_{exp['metadata']['name']}"
            f"_trial{trial['index']}.json")
        try:
            os.makedirs(self.profile_dir, exist_ok=True)
            with open(path, "w") as f:
                json.dump({"parsed": result}, f, indent=2, default=str)
            trial["profilePath"] = path
        except OSError as e:
            log.warning("profile write failed: %s", e)

    # -- job-mode trials ---------------------------------------------------

    def _trial_job_name(self, exp: dict, trial: dict) -> str:
        suffix = f"-r{trial['retries']}" if trial.get("retries") else ""
        return (f"{exp['metadata']['name']}-trial-"
                f"{trial['index']}{suffix}")

    def _create_trial_job(self, exp: dict, trial: dict) -> None:
        spec = exp["spec"]
        ns = exp["metadata"]["namespace"]
        name = self._trial_job_name(exp, trial)
        job = {
            "apiVersion": JOBS_API_VERSION,
            "kind": "JaxJob",
            "metadata": {
                **k8s.metadata(name, ns),
                "labels": {
                    LABEL_EXPERIMENT: exp["metadata"]["name"],
                    LABEL_TRIAL: str(trial["index"]),
                },
                "ownerReferences": [k8s.object_ref(exp)],
            },
            "spec": {
                # Preemptible background load: the scheduler may evict
                # this trial for any real workload; the controller
                # re-runs it with the same recorded seed.
                "priority": TRIAL_PRIORITY,
                "replicaSpecs": {
                    "Worker": {
                        "replicas": 1,
                        "restartPolicy": "Never",
                        "template": {"spec": {"containers": [{
                            "name": "trial",
                            "image": images.TORCH_CUDA,
                            "resources": images.gpu_resources(1),
                            "command": [
                                "python", "-m",
                                "kubeflow_tpu_torch.serving.scenarios",
                                "--scenario", spec["scenario"],
                                "--seed", str(trial["seed"]),
                                "--quick",
                                "--assignments",
                                json.dumps(trial["assignments"],
                                           sort_keys=True),
                            ],
                        }]}},
                    },
                },
            },
        }
        self.client.create(job)
        trial["jobName"] = name
        trial["state"] = "Running"

    def _collect_job_trials(self, exp: dict, trials: list[dict],
                            metric: str, spec: dict) -> None:
        ns = exp["metadata"]["namespace"]
        stopper = self._early_stopper(spec)
        completed_curves = [
            t.get("curve") for t in trials
            if t["state"] == "Succeeded" and t.get("curve")]
        for trial in trials:
            if trial["state"] in _TERMINAL or "jobName" not in trial:
                continue
            job = self.client.get_or_none(
                JOBS_API_VERSION, "JaxJob", trial["jobName"], ns)
            if job is None:
                continue
            if self._job_preempted(job):
                # A preempted trial's measurement window was poisoned by
                # the eviction: throw the sample away and re-run the
                # SAME assignments at the SAME seed under a fresh job.
                _M_TRIALS.labels("preempted").inc()
                self.client.delete(
                    JOBS_API_VERSION, "JaxJob", trial["jobName"], ns)
                trial["retries"] = int(trial.get("retries", 0)) + 1
                self._create_trial_job(exp, trial)
                continue
            jstatus = job.get("status", {})
            jstate = jstatus.get("state")
            metrics = jstatus.get("metrics", {})
            curve = [(int(s), float(v))
                     for s, v in jstatus.get("metricsHistory", [])]
            if (jstate not in ("Succeeded", "Failed") and stopper
                    and curve
                    and stopper.should_stop(curve, completed_curves)):
                # Early stop: the partial measurement IS the observation
                # (underperforming, not broken).
                self.client.delete(
                    JOBS_API_VERSION, "JaxJob", trial["jobName"], ns)
                trial["state"] = "Succeeded"
                trial["earlyStopped"] = True
                trial["objectiveValue"] = float(curve[-1][1])
                trial["curve"] = [[s, v] for s, v in curve]
                _M_TRIALS.labels("early_stopped").inc()
                continue
            if jstate == "Succeeded":
                trial["state"] = "Succeeded"
                if metric in metrics:
                    trial["objectiveValue"] = float(metrics[metric])
                if curve:
                    trial["curve"] = [[s, v] for s, v in curve]
                _M_TRIALS.labels("succeeded").inc()
            elif jstate == "Failed":
                trial["state"] = "Failed"
                _M_TRIALS.labels("failed").inc()

    @staticmethod
    def _early_stopper(spec: dict) -> MedianEarlyStop | None:
        es = spec.get("earlyStop")
        if not es or es.get("policy", "median") != "median":
            return None
        return MedianEarlyStop(min_trials=int(es.get("minTrials", 3)))

    @staticmethod
    def _job_preempted(job: dict) -> bool:
        meta = job.get("metadata", {})
        if meta.get("annotations", {}).get(ANN_PREEMPTED_BY):
            return True
        sched = job.get("status", {}).get("scheduling") or {}
        return bool(sched.get("preemptedBy"))

    # -- verdict + promotion ----------------------------------------------

    def _update_best(self, spec: dict, status: dict, succeeded: list[dict],
                     maximize: bool) -> None:
        if not succeeded:
            return
        best = (max if maximize else min)(
            succeeded, key=lambda t: t["objectiveValue"])
        status["bestObjectiveValue"] = best["objectiveValue"]
        status["bestTrialIndex"] = best["index"]
        status["bestAssignments"] = best["assignments"]
        _M_BEST.labels(spec.get("scenario", "?")).set(
            float(best["objectiveValue"]))
        baseline = next((t for t in succeeded if t["index"] == 0), None)
        if baseline is not None:
            status["baselineObjectiveValue"] = baseline["objectiveValue"]
            base = float(baseline["objectiveValue"])
            if base != 0:
                gain = (float(best["objectiveValue"]) - base) / abs(base)
                if not maximize:
                    gain = -gain
                status["improvementPercent"] = round(gain * 100.0, 3)

    def _promote(self, exp: dict, spec: dict, status: dict) -> None:
        """Ship the winner as a candidate version on the target
        InferenceService: the RolloutController walks it under SLO
        gates and rolls back on breach — promotion is recorded here and
        reversible there."""
        promo = spec.get("promotion") or {}
        target = promo.get("target")
        if not target or status.get("bestAssignments") is None:
            return
        min_gain = float(promo.get("minImprovementPercent", 0.0))
        gain = status.get("improvementPercent")
        if gain is None or gain < min_gain:
            status["promotion"] = {
                "target": target, "skipped": True,
                "reason": f"improvement {gain}% below minimum "
                          f"{min_gain}%"}
            return
        ns = exp["metadata"]["namespace"]
        version_name = f"{exp['metadata']['name']}-tuned"
        engine = {k: v for k, v in status["bestAssignments"].items()
                  if k != "trainingSteps"}

        def _write(client):
            svc = client.get_or_none(
                INFERENCE_API_VERSION, INFERENCE_KIND, target, ns)
            if svc is None:
                return None
            sspec = svc.setdefault("spec", {})
            versions = sspec.get("versions") or [{
                "name": "incumbent",
                "weightsRef": promo.get(
                    "weightsRef", sspec.get("model", target)),
                "traffic": 100.0,
            }]
            incumbent = dict(versions[0])
            incumbent["traffic"] = 0.0
            candidate = {
                "name": version_name,
                "weightsRef": incumbent["weightsRef"],
                "traffic": 100.0,
                "engine": engine,
            }
            sspec["versions"] = validate_versions([incumbent, candidate])
            return client.update(svc)

        written = retry_on_conflict(self.client, _write)
        if written is None:
            status["promotion"] = {
                "target": target, "skipped": True,
                "reason": f"InferenceService {ns}/{target} not found"}
            return
        status["promotion"] = {
            "target": target,
            "version": version_name,
            "engine": engine,
            "improvementPercent": gain,
            "at": round(float(self.clock()), 3),
        }
        log.info("experiment %s promoted %s to %s/%s (gain %.2f%%)",
                 exp["metadata"]["name"], engine, ns, target, gain)


def scenario_objective(sc) -> str:
    return getattr(sc, "objective", "tokens_per_sec")


def scenario_optimization(sc) -> str:
    return getattr(sc, "optimization", "maximize")
