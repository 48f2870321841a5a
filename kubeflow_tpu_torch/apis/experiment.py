"""Experiment CRD API — closed-loop knob search against serving SLOs.

A copy of ``kubeflow_tpu/apis/experiment.py`` (standard library only), kept in
this package so the port imports nothing of the JAX one; the CRs it
builds are JAX's.

Where a StudyJob (apis/tuning.py) tunes an arbitrary trial template, an
Experiment is specialised for the serving engine: it names a registered
bench_serving scenario (serving/scenarios.py), a knob space drawn from
the engine's KNOB_CATALOG, and a search algorithm; the controller runs
measured trials, reads objectives from the histogram exposition via the
autoscaler's scrape_signals path, and ships the winner through the
rollout controller as a candidate version.

Analogue of Katib's Experiment layered over kubebench-style measured
runs (kubeflow/katib studyjobcontroller.libsonnet + kubebench job
templates) — here both halves are one CRD.
"""

from __future__ import annotations

from kubeflow_tpu_torch.apis import API_GROUP
from kubeflow_tpu_torch.manifests import objects as k8s

EXPERIMENT_KIND = "Experiment"
EXPERIMENT_PLURAL = "experiments"
EXPERIMENT_API_VERSION = f"{API_GROUP}/v1"

# Superset of the StudyJob algorithms: tpe and the median early-stop
# policy were added for experiments (tuning/suggestions.py).
ALGORITHMS = ("random", "grid", "hyperband", "bayesianoptimization", "tpe")

OPTIMIZATION_TYPES = ("maximize", "minimize")

# Objective metrics every trial reports — the scrape_signals vector plus
# throughput and KV footprint (serving/scenarios.py trial_objectives).
OBJECTIVE_METRICS = (
    "tokens_per_sec",
    "ttft_p99_s",
    "inter_token_p99_s",
    "queue_wait_p99_s",
    "kv_utilization",
    "kv_bytes_peak",
)

TRIAL_MODES = ("inprocess", "job")

# Engine knob catalog: the tunable constants the serving stack exposes,
# with safe ranges. Experiments validate their parameter space against
# this; docs/tuning.md renders it. Ranges are conservative — a knob can
# be legal outside its safe range, but an Experiment won't propose it.
KNOB_CATALOG: dict[str, dict] = {
    "slots": {
        "type": "int", "min": 1, "max": 64,
        "description": "continuous-batching slot count (decode width)",
    },
    "kv_block_size": {
        "type": "int", "min": 4, "max": 128,
        "description": "paged-KV block size in tokens; must divide the "
                       "virtual row width (prefill_len + max_new_tokens)",
    },
    "prefill_len_buckets": {
        "type": "int", "min": 0, "max": 8,
        "description": "number of padded prefill length buckets "
                       "(0 = single worst-case width)",
    },
    "speculative_k": {
        "type": "int", "min": 0, "max": 8,
        "description": "draft tokens per speculative step (0 = off)",
    },
    "prefill_chunk_tokens": {
        "type": "int", "min": 64, "max": 4096,
        "description": "chunked-prefill slice width interleaved with decode",
    },
    "prefix_cache_slots": {
        "type": "int", "min": 0, "max": 256,
        "description": "prefix-cache capacity in cached prefixes",
    },
    "kv_import_crossover_tokens": {
        "type": "int", "min": 16, "max": 8192,
        "description": "prefix length above which importing peer KV beats "
                       "recomputing prefill",
    },
    "queue_depth_target": {
        "type": "double", "min": 0.5, "max": 32.0,
        "description": "autoscaler queued-requests-per-replica target",
    },
}


def validate_knobs(parameters: list[dict]) -> list[dict]:
    """Check a katib-style parameter list against the knob catalog.

    Unknown knobs are allowed (scenarios may expose scenario-local
    parameters), but a knob present in the catalog must stay inside its
    safe range.
    """
    for p in parameters:
        entry = KNOB_CATALOG.get(p.get("name", ""))
        if entry is None:
            continue
        space = p.get("feasibleSpace", {})
        lo, hi = space.get("min"), space.get("max")
        if lo is not None and float(lo) < float(entry["min"]):
            raise ValueError(
                f"knob {p['name']!r} min {lo} below safe range "
                f">= {entry['min']}")
        if hi is not None and float(hi) > float(entry["max"]):
            raise ValueError(
                f"knob {p['name']!r} max {hi} above safe range "
                f"<= {entry['max']}")
    return parameters


def experiment_crd() -> dict:
    schema = {
        "type": "object",
        "properties": {
            "spec": {
                "type": "object",
                "required": ["scenario"],
                "properties": {
                    "scenario": {"type": "string"},
                    "objective": {
                        "type": "object",
                        "properties": {
                            "type": {
                                "type": "string",
                                "enum": list(OPTIMIZATION_TYPES),
                            },
                            "objectiveMetricName": {
                                "type": "string",
                                "enum": list(OBJECTIVE_METRICS),
                            },
                            "goal": {"type": "number"},
                        },
                    },
                    "algorithm": {
                        "type": "string", "enum": list(ALGORITHMS),
                    },
                    "parameters": {
                        "type": "array",
                        "items": {
                            "type": "object",
                            "properties": {
                                "name": {"type": "string"},
                                "parameterType": {"type": "string"},
                                "feasibleSpace": {
                                    "type": "object",
                                    "x-kubernetes-preserve-unknown-fields":
                                        True,
                                },
                            },
                        },
                    },
                    "parallelTrialCount": {"type": "integer", "minimum": 1},
                    "maxTrialCount": {"type": "integer", "minimum": 1},
                    "maxFailedTrialCount": {"type": "integer", "minimum": 0},
                    "seed": {"type": "integer", "minimum": 0},
                    "trialMode": {
                        "type": "string", "enum": list(TRIAL_MODES),
                    },
                    "earlyStop": {
                        "type": "object",
                        "properties": {
                            "policy": {
                                "type": "string", "enum": ["median"],
                            },
                            "minTrials": {"type": "integer", "minimum": 1},
                        },
                    },
                    "promotion": {
                        "type": "object",
                        "properties": {
                            "target": {"type": "string"},
                            "minImprovementPercent": {"type": "number"},
                        },
                    },
                },
            },
            "status": {
                "type": "object",
                "x-kubernetes-preserve-unknown-fields": True,
            },
        },
    }
    return k8s.crd(
        group=API_GROUP,
        kind=EXPERIMENT_KIND,
        plural=EXPERIMENT_PLURAL,
        short_names=["exp"],
        categories=["all", "kubeflow-tpu"],
        versions=[
            k8s.crd_version(
                "v1",
                schema=schema,
                storage=True,
                printer_columns=[
                    k8s.printer_column("State", ".status.state"),
                    k8s.printer_column("Scenario", ".spec.scenario"),
                    k8s.printer_column("Best", ".status.bestObjectiveValue"),
                    k8s.printer_column(
                        "Trials", ".status.completedTrialCount", "integer"),
                ],
            )
        ],
    )


def experiment(
    name: str,
    namespace: str,
    scenario: str,
    *,
    parameters: list[dict] | None = None,
    objective_metric: str = "tokens_per_sec",
    optimization_type: str = "maximize",
    goal: float | None = None,
    algorithm: str = "tpe",
    parallel_trials: int = 2,
    max_trials: int = 12,
    max_failed_trials: int = 3,
    seed: int = 0,
    trial_mode: str = "inprocess",
    early_stop: dict | None = None,
    promotion: dict | None = None,
) -> dict:
    if algorithm not in ALGORITHMS:
        raise ValueError(
            f"unknown algorithm {algorithm!r}; available {ALGORITHMS}")
    if objective_metric not in OBJECTIVE_METRICS:
        raise ValueError(
            f"unknown objective metric {objective_metric!r}; "
            f"available {OBJECTIVE_METRICS}")
    if trial_mode not in TRIAL_MODES:
        raise ValueError(
            f"unknown trial mode {trial_mode!r}; available {TRIAL_MODES}")
    objective: dict = {
        "type": optimization_type,
        "objectiveMetricName": objective_metric,
    }
    if goal is not None:
        objective["goal"] = goal
    spec: dict = {
        "scenario": scenario,
        "objective": objective,
        "algorithm": algorithm,
        "parallelTrialCount": parallel_trials,
        "maxTrialCount": max_trials,
        "maxFailedTrialCount": max_failed_trials,
        "seed": seed,
        "trialMode": trial_mode,
    }
    if parameters is not None:
        spec["parameters"] = validate_knobs(list(parameters))
    if early_stop is not None:
        spec["earlyStop"] = dict(early_stop)
    if promotion is not None:
        spec["promotion"] = dict(promotion)
    return {
        "apiVersion": EXPERIMENT_API_VERSION,
        "kind": EXPERIMENT_KIND,
        "metadata": k8s.metadata(name, namespace),
        "spec": spec,
    }
