"""``gpu-rl``: the RLJob CRD and an example RL workload on the port;
counterpart of ``kubeflow_tpu/manifests/packages/rl.py``'s ``rl-job``.

The RLJob controller rides the port's manager (``python -m
kubeflow_tpu_torch.operators``); this prototype ships the CRD and a CR
declaring the whole loop: a learner gang, an elastic preemptible actor
pool, the rollout shape and the weight-push policy. The mapping from
JAX's: ``chips_per_replica`` becomes ``gpus_per_replica`` (written to the
CR's ``tpuChipsPerReplica``, which counts GPUs; 0 runs the pods on the
CPU) and the image is the port's.
"""

from __future__ import annotations

from kubeflow_tpu_torch.apis import rl as rl_api
from kubeflow_tpu_torch.manifests import images
from kubeflow_tpu_torch.manifests.core import (
    DEFAULT_NAMESPACE,
    ParamSpec,
    prototype,
)


@prototype(
    "gpu-rl",
    "RLJob CRD + an example Podracer-style RL workload on GPUs: learner "
    "gang at high priority pushing live weights into an elastic "
    "preemptible actor pool every K steps (rl-job's counterpart)",
    params=[
        ParamSpec("name", "rl-smoke"),
        ParamSpec("namespace", DEFAULT_NAMESPACE),
        ParamSpec("image", images.TORCH_CUDA),
        ParamSpec("model", "lm-test-tiny", "registry model (the policy)"),
        ParamSpec("learner_replicas", 1, "learner gang size"),
        ParamSpec("learner_priority", rl_api.DEFAULT_LEARNER_PRIORITY,
                  "scheduler priority of the learner gang"),
        ParamSpec("learner_steps", 100, "optimizer steps to run"),
        ParamSpec("actor_replicas", 2, "rollout actors at start"),
        ParamSpec("actor_min_replicas", 1,
                  "elastic floor the scheduler may shrink the pool to"),
        ParamSpec("actor_max_replicas", 4,
                  "elastic ceiling for opportunistic grow"),
        ParamSpec("actor_priority", rl_api.DEFAULT_ACTOR_PRIORITY,
                  "scheduler priority of the actor pool (preemptible)"),
        ParamSpec("push_every_steps", rl_api.DEFAULT_PUSH_EVERY_STEPS,
                  "optimizer steps between live weight pushes"),
        ParamSpec("weights_max_lag", rl_api.DEFAULT_WEIGHTS_MAX_LAG,
                  "max weight-epoch skew before an actor leaves "
                  "rollout routing"),
        ParamSpec("prompt_len", 8, "rollout prompt length"),
        ParamSpec("max_new_tokens", 16, "rollout generation length"),
        ParamSpec("gpus_per_replica", 1,
                  "nvidia.com/gpu per learner/actor pod (0 = CPU)"),
    ],
)
def gpu_rl(
    name: str,
    namespace: str,
    image: str,
    model: str,
    learner_replicas: int,
    learner_priority: int,
    learner_steps: int,
    actor_replicas: int,
    actor_min_replicas: int,
    actor_max_replicas: int,
    actor_priority: int,
    push_every_steps: int,
    weights_max_lag: int,
    prompt_len: int,
    max_new_tokens: int,
    gpus_per_replica: int,
) -> list[dict]:
    cr = rl_api.rl_job(
        name,
        namespace,
        model,
        image=image,
        learner={
            "replicas": learner_replicas,
            "priority": learner_priority,
            "steps": learner_steps,
            "pushEverySteps": push_every_steps,
            "tpuChipsPerReplica": gpus_per_replica,
        },
        actors={
            "replicas": actor_replicas,
            "minReplicas": actor_min_replicas,
            "maxReplicas": actor_max_replicas,
            "priority": actor_priority,
            "tpuChipsPerReplica": gpus_per_replica,
            # The live weight push swaps under the paged pool's
            # continuous decoder; the controller pins these defaults too.
            "engine": {"kv_layout": "paged"},
        },
        rollout={"promptLen": prompt_len,
                 "maxNewTokens": max_new_tokens},
        weights={"maxLag": weights_max_lag},
    )
    rl_api.validate_rl_job(cr)
    return [rl_api.rl_job_crd(), cr]
