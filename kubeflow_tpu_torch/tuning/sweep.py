"""Tuning sweep CLI; the port's counterpart of
``kubeflow_tpu/tuning/sweep.py``, over the port's ExperimentController,
suggestion algorithms, scenario registry and fake apiserver.

``python -m kubeflow_tpu_torch.tuning.sweep --scenario synthetic-knobs
--policies random,tpe --trials 12 --seed 7 --promote`` runs one full
Experiment per policy through the controller on the fake apiserver (same
reconcile loop, same suggestion algorithms, same scenario registry as the
cluster path) and emits one JSON record, JAX's, with JAX's gates
(``--device`` picks where scenarios that drive the decoder run: the card
unless ``cpu``):

- per-policy best objective and best-so-far trace (monotone by
  construction of the experiment status — the CI gate re-checks it);
- trial economy: the first trial index at which each later policy
  reaches the FIRST policy's final best (the gate: bayesian/tpe must
  reach random's best in at most half the trials);
- improvement over the checked-in defaults (trial 0 is always the
  baseline) and, with ``--promote``, the recorded promotion of the
  winner onto a target InferenceService (versions + engine overrides —
  what the rollout controller walks in a real cluster).
"""

from __future__ import annotations

import argparse
import functools
import json
import sys


def run_policy(scenario: str, policy: str, trials: int, seed: int,
               promote: bool, device: str = "cuda") -> dict:
    from kubeflow_tpu_torch.apis.experiment import experiment, experiment_crd
    from kubeflow_tpu_torch.apis.inference import (
        inference_service,
        inference_service_crd,
    )
    from kubeflow_tpu_torch.k8s_fake import FakeApiServer
    from kubeflow_tpu_torch.operators.experiment import (
        ExperimentController,
        _default_run_trial,
    )

    api = FakeApiServer()
    api.ensure_namespace("kubeflow")
    api.apply(experiment_crd())
    # The job kinds need no CRD here: the port's kind registry knows them.
    promotion = None
    if promote:
        api.apply(inference_service_crd())
        svc = inference_service("sweep-target", "kubeflow", "lm-test-tiny")
        for obj in (svc if isinstance(svc, list) else [svc]):
            if obj.get("kind") == "InferenceService":
                api.create(obj)
        promotion = {"target": "sweep-target",
                     "minImprovementPercent": 0.0}
    api.create(experiment(
        f"sweep-{policy}", "kubeflow", scenario,
        algorithm=policy, max_trials=trials, parallel_trials=2,
        seed=seed, promotion=promotion))
    ctrl = ExperimentController(
        api, run_trial=functools.partial(_default_run_trial, device=device))
    for _ in range(trials + 4):
        ctrl.reconcile_all()
        got = api.get("kubeflow-tpu.org/v1", "Experiment",
                      f"sweep-{policy}", "kubeflow")
        if got["status"].get("state") in ("Succeeded", "Failed"):
            break
    status = got["status"]
    done = sorted(
        (t for t in status.get("trials", [])
         if t.get("objectiveValue") is not None),
        key=lambda t: t["index"])
    trace, best = [], None
    for t in done:
        v = float(t["objectiveValue"])
        best = v if best is None else max(best, v)
        trace.append(round(best, 6))
    out = {
        "policy": policy,
        "state": status.get("state"),
        "seed": status.get("seed"),
        "trials": len(status.get("trials", [])),
        "bestObjectiveValue": status.get("bestObjectiveValue"),
        "bestAssignments": status.get("bestAssignments"),
        "baselineObjectiveValue": status.get("baselineObjectiveValue"),
        "improvementPercent": status.get("improvementPercent"),
        "bestSoFarTrace": trace,
    }
    if promote:
        out["promotion"] = status.get("promotion")
        svc = api.get("kubeflow-tpu.org/v1", "InferenceService",
                      "sweep-target", "kubeflow")
        out["promotedVersions"] = svc["spec"].get("versions")
    return out


def trials_to_reach(trace: list[float], target: float) -> int | None:
    """1-based trial count at which best-so-far first reaches target."""
    for i, v in enumerate(trace):
        if v >= target:
            return i + 1
    return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--scenario", default="synthetic-knobs")
    ap.add_argument("--policies", default="random,tpe",
                    help="comma list; the FIRST is the economy baseline")
    ap.add_argument("--trials", type=int, default=12)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--promote", action="store_true",
                    help="promote each policy's winner onto a fake "
                         "InferenceService and record the versions write")
    ap.add_argument("--device", default="cuda",
                    help="where decoder scenarios run: 'cuda' or 'cpu'")
    args = ap.parse_args(argv)

    policies = [p.strip() for p in args.policies.split(",") if p.strip()]
    results = {p: run_policy(args.scenario, p, args.trials, args.seed,
                             args.promote, args.device)
               for p in policies}
    record: dict = {
        "scenario": args.scenario,
        "seed": args.seed,
        "maxTrials": args.trials,
        "policies": results,
        "regression": False,
    }
    reasons = []
    for p, r in results.items():
        if r["state"] != "Succeeded":
            reasons.append(f"{p} experiment ended {r['state']}")
        trace = r["bestSoFarTrace"]
        if any(b < a for a, b in zip(trace, trace[1:])):
            reasons.append(f"{p} best-so-far trace not monotone")
        if (r.get("improvementPercent") is None
                or r["improvementPercent"] <= 0):
            reasons.append(
                f"{p} found nothing better than the defaults "
                f"(improvement {r.get('improvementPercent')}%)")
        if args.promote and not (r.get("promotion") or {}).get("version"):
            reasons.append(f"{p} promotion not recorded")
    if len(policies) > 1:
        base = policies[0]
        base_best = results[base].get("bestObjectiveValue")
        base_n = len(results[base]["bestSoFarTrace"])
        for p in policies[1:]:
            n = trials_to_reach(results[p]["bestSoFarTrace"],
                                float(base_best))
            record[f"{p}TrialsToReach_{base}Best"] = n
            if n is None or n > base_n / 2:
                reasons.append(
                    f"{p} needed {n} trials to reach {base}'s best "
                    f"({base_best}); gate is <= {base_n // 2}")
    if reasons:
        record["regression"] = True
        record["reasons"] = reasons
    print(json.dumps(record, indent=2, default=str))
    return 1 if record["regression"] else 0


if __name__ == "__main__":
    sys.exit(main())
