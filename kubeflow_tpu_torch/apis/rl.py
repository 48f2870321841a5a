"""RLJob CRD API, the train-serve RL workload (Podracer-style); a copy of
``kubeflow_tpu/apis/rl.py`` (standard library only).

ONE object declares both halves of an on-policy RL loop and the pipe
between them:

- a **learner** gang: worker pods running the learner loop
  (:mod:`kubeflow_tpu_torch.train.rl`), which consumes actor rollouts
  through the prefetcher and pushes fresh weights to every actor every K
  optimizer steps over the live weight push (``:weights``);
- an **actor pool**: continuous-decoder model servers
  (``python -m kubeflow_tpu_torch.serving``) generating rollouts,
  elastic and PREEMPTIBLE by definition.

The RLJob controller (:mod:`kubeflow_tpu_torch.operators.rl`) lowers the
CR into two scheduler-managed JaxJobs at different priorities. The
schema is JAX's: ``tpuChipsPerReplica`` counts a pod's GPUs
(``nvidia.com/gpu``; 0 = a CPU pod) and ``spec.tpu.accelerator`` names
the GPU pool.
"""

from __future__ import annotations

from typing import Mapping

from kubeflow_tpu_torch.apis import API_GROUP
from kubeflow_tpu_torch.manifests import objects as k8s

RL_KIND = "RLJob"
RL_PLURAL = "rljobs"
RL_API_VERSION = f"{API_GROUP}/v1"

# Defaults the operator and validation share. The priority GAP is the
# contract: the learner outranks its own actors, so a squeezed cluster
# shrinks/preempts rollout capacity before it ever stalls learning.
DEFAULT_LEARNER_PRIORITY = 100
DEFAULT_ACTOR_PRIORITY = 0
DEFAULT_PUSH_EVERY_STEPS = 2
DEFAULT_WEIGHTS_MAX_LAG = 1


def rl_job_schema() -> dict:
    learner_schema = {
        "type": "object",
        "properties": {
            "replicas": {"type": "integer", "minimum": 1},
            "tpuChipsPerReplica": {"type": "integer", "minimum": 0},
            "priority": {"type": "integer"},
            "queue": {"type": "string"},
            "steps": {"type": "integer", "minimum": 1},
            "batchSize": {"type": "integer", "minimum": 1},
            "pushEverySteps": {"type": "integer", "minimum": 1},
            "optimizer": {"type": "object",
                          "x-kubernetes-preserve-unknown-fields": True},
        },
    }
    actors_schema = {
        "type": "object",
        "properties": {
            "replicas": {"type": "integer", "minimum": 1},
            "minReplicas": {"type": "integer", "minimum": 1},
            "maxReplicas": {"type": "integer", "minimum": 1},
            "tpuChipsPerReplica": {"type": "integer", "minimum": 0},
            "priority": {"type": "integer"},
            "queue": {"type": "string"},
            # Engine knobs passed to each actor's model server
            # verbatim (kv_layout, speculative_k, tp_shards...).
            "engine": {"type": "object",
                       "x-kubernetes-preserve-unknown-fields": True},
        },
    }
    rollout_schema = {
        "type": "object",
        "properties": {
            "promptLen": {"type": "integer", "minimum": 1},
            "maxNewTokens": {"type": "integer", "minimum": 1},
        },
    }
    weights_schema = {
        "type": "object",
        "properties": {
            # Bounded version skew: actors lagging the fleet's weights
            # epoch by more than maxLag pushes leave the rollout
            # routing set until a later push lands on them.
            "maxLag": {"type": "integer", "minimum": 0},
            "chunkBytes": {"type": "integer", "minimum": 1},
        },
    }
    return {
        "type": "object",
        "properties": {
            "spec": {
                "type": "object",
                "required": ["model"],
                "properties": {
                    "model": {"type": "string"},
                    "image": {"type": "string"},
                    "tpu": {
                        "type": "object",
                        "properties": {
                            "accelerator": {"type": "string"},
                            "topology": {"type": "string"},
                        },
                    },
                    "learner": learner_schema,
                    "actors": actors_schema,
                    "rollout": rollout_schema,
                    "weights": weights_schema,
                },
            },
            "status": {"type": "object",
                       "x-kubernetes-preserve-unknown-fields": True},
        },
    }


def rl_job_crd() -> dict:
    return k8s.crd(
        group=API_GROUP,
        kind=RL_KIND,
        plural=RL_PLURAL,
        short_names=["rlj"],
        categories=["all", "kubeflow-tpu"],
        versions=[
            k8s.crd_version(
                "v1",
                schema=rl_job_schema(),
                storage=True,
                printer_columns=[
                    k8s.printer_column("Model", ".spec.model"),
                    k8s.printer_column("Phase", ".status.phase"),
                    k8s.printer_column("Weights",
                                       ".status.weightsVersion",
                                       "integer"),
                    k8s.printer_column("Age",
                                       ".metadata.creationTimestamp",
                                       "date"),
                ],
            )
        ],
    )


def rl_job(
    name: str,
    namespace: str,
    model: str,
    *,
    image: str = "",
    learner: dict | None = None,
    actors: dict | None = None,
    rollout: dict | None = None,
    weights: dict | None = None,
    tpu: dict | None = None,
) -> dict:
    """Build an RLJob CR. ``learner``/``actors``/``rollout``/``weights``
    override the schema blocks above; omitted fields take the operator
    defaults (1 learner at priority 100, 2 preemptible actors at
    priority 0, push every 2 steps, max weight lag 1)."""
    spec: dict = {"model": model}
    if image:
        spec["image"] = image
    if tpu:
        spec["tpu"] = dict(tpu)
    if learner:
        spec["learner"] = dict(learner)
    if actors:
        spec["actors"] = dict(actors)
    if rollout:
        spec["rollout"] = dict(rollout)
    if weights:
        spec["weights"] = dict(weights)
    return {
        "apiVersion": RL_API_VERSION,
        "kind": RL_KIND,
        "metadata": k8s.metadata(name, namespace, {"app": name}),
        "spec": spec,
    }


class RLJobValidationError(ValueError):
    pass


def validate_rl_job(job: Mapping) -> None:
    spec = job.get("spec", {})
    name = job.get("metadata", {}).get("name", "<unnamed>")
    if not spec.get("model"):
        raise RLJobValidationError(f"RLJob {name}: spec.model is required")
    learner = spec.get("learner") or {}
    actors = spec.get("actors") or {}
    lp = int(learner.get("priority", DEFAULT_LEARNER_PRIORITY))
    ap = int(actors.get("priority", DEFAULT_ACTOR_PRIORITY))
    if lp <= ap:
        # The whole design rests on this gap: actors must be the
        # capacity the scheduler reclaims FIRST.
        raise RLJobValidationError(
            f"RLJob {name}: learner priority {lp} must exceed actor "
            f"priority {ap} (actors are preemptible by definition)")
    reps = int(actors.get("replicas", 2))
    lo = int(actors.get("minReplicas", reps))
    hi = int(actors.get("maxReplicas", max(reps, lo)))
    if not 1 <= lo <= hi:
        raise RLJobValidationError(
            f"RLJob {name}: actor elastic range [{lo}, {hi}] invalid")
    if not lo <= reps <= hi:
        raise RLJobValidationError(
            f"RLJob {name}: actors.replicas {reps} outside "
            f"[{lo}, {hi}]")
    push_every = int(learner.get("pushEverySteps",
                                 DEFAULT_PUSH_EVERY_STEPS))
    if push_every < 1:
        raise RLJobValidationError(
            f"RLJob {name}: pushEverySteps must be >= 1")
    max_lag = int((spec.get("weights") or {}).get(
        "maxLag", DEFAULT_WEIGHTS_MAX_LAG))
    if max_lag < 0:
        raise RLJobValidationError(
            f"RLJob {name}: weights.maxLag must be >= 0")
