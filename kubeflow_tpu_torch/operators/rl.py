"""RLJob controller: lower one RL workload into two scheduler-managed
gangs; a copy of ``kubeflow_tpu/operators/rl.py`` rendering the port.

One RLJob CR becomes

- ``<name>-learner``: a JaxJob running the learner loop
  (``python -m kubeflow_tpu_torch.train.rl``) at HIGH priority,
  non-preemptible: the learner is the job;
- ``<name>-actors``: a JaxJob whose workers each run a continuous-decoding
  model server (``python -m kubeflow_tpu_torch.serving``, the rollout
  fleet) at LOW priority, preemptible, and ELASTIC over
  ``[minReplicas, maxReplicas]`` hosts.

Both children carry ``spec.priority``, which opts them into the cluster
scheduler's gang placement (``kubeflow_tpu_torch.scheduler``): the
learner gang admits all-or-nothing, the actor pool is the first capacity
reclaimed under pressure. The learner reaches its actors by pod DNS
(``KUBEFLOW_TPU_RL_ACTORS``) and pushes weights at their ``:weights``
endpoints.

The mapping from JAX's: the port's image and modules, ``nvidia.com/gpu``
for the TPU resources (``tpuChipsPerReplica`` counts GPUs), and a pod
with 0 GPUs runs on the CPU (the learner's config gets ``"device":
"cpu"``, the actor's command ``--device=cpu``). One repair: the actor
gang's ``elastic.minReplicas`` is raised to its pod count, without which
the job controller refuses the gang (JAX's lowering writes the CR's
``minReplicas`` as given, below ``replicas`` in its own defaults).
"""

from __future__ import annotations

import copy
import json
import logging

from kubeflow_tpu_torch.apis import jobs as jobs_api
from kubeflow_tpu_torch.apis.rl import (
    DEFAULT_ACTOR_PRIORITY,
    DEFAULT_LEARNER_PRIORITY,
    DEFAULT_PUSH_EVERY_STEPS,
    DEFAULT_WEIGHTS_MAX_LAG,
    RL_API_VERSION,
    RL_KIND,
    RLJobValidationError,
    validate_rl_job,
)
from kubeflow_tpu_torch.manifests import images
from kubeflow_tpu_torch.manifests import objects as k8s
from kubeflow_tpu_torch.operators.base import Controller

log = logging.getLogger(__name__)

REST_PORT = 8500
RLJOB_LABEL = "kubeflow-tpu.org/rl-job"
ROLE_LABEL = "kubeflow-tpu.org/rl-role"

# Env var carrying the actor pool's model-server addresses into the
# learner pod (comma-separated host:port).
ENV_RL_ACTORS = "KUBEFLOW_TPU_RL_ACTORS"


def _phase_of(children: list[dict]) -> str:
    """Aggregate child JaxJob states into one RLJob phase. The LEARNER
    decides success (actors serve until torn down); any failed child
    fails the job."""
    states = [((c.get("status") or {}).get("state") or "Pending")
              for c in children]
    if any(s == "Failed" for s in states):
        return "Failed"
    if not children:
        return "Pending"
    learner_state = states[0]
    if learner_state == "Succeeded":
        return "Succeeded"
    if any(s == "Running" for s in states):
        return "Running"
    return "Pending"


class RLJobController(Controller):
    """RLJob CR → learner JaxJob + elastic preemptible actor JaxJob."""

    api_version = RL_API_VERSION
    kind = RL_KIND

    # -- child shaping -------------------------------------------------

    @staticmethod
    def learner_name(name: str) -> str:
        return f"{name}-learner"

    @staticmethod
    def actors_name(name: str) -> str:
        return f"{name}-actors"

    @staticmethod
    def actor_addrs(name: str, ns: str, replicas: int) -> list[str]:
        """Actor model-server addresses, one per worker pod, the pod-DNS
        spelling the JaxJob headless service resolves."""
        actors = RLJobController.actors_name(name)
        return [f"{actors}-worker-{i}.{actors}.{ns}:{REST_PORT}"
                for i in range(replicas)]

    def _learner_job(self, rl: dict) -> dict:
        name = rl["metadata"]["name"]
        ns = rl["metadata"]["namespace"]
        spec = rl.get("spec", {})
        learner = spec.get("learner") or {}
        rollout = spec.get("rollout") or {}
        weights = spec.get("weights") or {}
        actors = spec.get("actors") or {}
        replicas = int(learner.get("replicas", 1))
        cfg = {
            "model": spec["model"],
            "steps": int(learner.get("steps", 100)),
            "batch_size": int(learner.get("batchSize", 4)),
            "push_every_steps": int(learner.get(
                "pushEverySteps", DEFAULT_PUSH_EVERY_STEPS)),
            "prompt_len": int(rollout.get("promptLen", 8)),
            "max_new_tokens": int(rollout.get("maxNewTokens", 16)),
            "weights_max_lag": int(weights.get(
                "maxLag", DEFAULT_WEIGHTS_MAX_LAG)),
        }
        if learner.get("optimizer"):
            cfg["optimizer"] = dict(learner["optimizer"])
        gpus = int(learner.get("tpuChipsPerReplica", 0))
        if not gpus:
            cfg["device"] = "cpu"
        template = {
            "spec": {
                "containers": [
                    k8s.container(
                        "learner",
                        spec.get("image") or images.TORCH_CUDA,
                        command=["python", "-m",
                                 "kubeflow_tpu_torch.train.rl",
                                 json.dumps(cfg, sort_keys=True)],
                        env={ENV_RL_ACTORS: ",".join(self.actor_addrs(
                            name, ns,
                            int(actors.get("replicas", 2))))},
                        resources=images.gpu_resources(gpus),
                    )
                ],
                "restartPolicy": "Never",
            }
        }
        job = {
            "apiVersion": jobs_api.JOBS_API_VERSION,
            "kind": jobs_api.JAX_JOB_KIND,
            "metadata": k8s.metadata(
                self.learner_name(name), ns,
                {RLJOB_LABEL: name, ROLE_LABEL: "learner"}),
            "spec": {
                "replicaSpecs": {
                    "Worker": {"replicas": replicas,
                               "restartPolicy": "OnFailure",
                               "template": template}
                },
                # Scheduler-managed gang at the HIGH priority: all-or-
                # nothing admission, never sacrificed for its own
                # actors.
                "priority": int(learner.get(
                    "priority", DEFAULT_LEARNER_PRIORITY)),
                "preemptible": False,
                "runPolicy": {"cleanPodPolicy": "Running"},
            },
        }
        if learner.get("queue"):
            job["spec"]["queue"] = learner["queue"]
        if spec.get("tpu"):
            job["spec"]["tpu"] = dict(spec["tpu"])
        return job

    def _actors_job(self, rl: dict) -> dict:
        name = rl["metadata"]["name"]
        ns = rl["metadata"]["namespace"]
        spec = rl.get("spec", {})
        actors = spec.get("actors") or {}
        replicas = int(actors.get("replicas", 2))
        lo = int(actors.get("minReplicas", replicas))
        hi = int(actors.get("maxReplicas", max(replicas, lo)))
        engine = dict(actors.get("engine") or {})
        # The rollout fleet serves the live weight-push path, which
        # rides the paged pool; continuous mode is what update_weights
        # swaps under.
        engine.setdefault("kv_layout", "paged")
        args = [f"--model-name={spec['model']}",
                f"--rest-port={REST_PORT}",
                "--decode-mode=continuous"]
        for key in sorted(engine):
            val = engine[key]
            flag = "--" + key.replace("_", "-")
            if isinstance(val, bool):
                if val:
                    args.append(flag)
            else:
                args.append(f"{flag}={val}")
        gpus = int(actors.get("tpuChipsPerReplica", 0))
        if not gpus:
            args.append("--device=cpu")
        template = {
            "spec": {
                "containers": [
                    k8s.container(
                        "actor",
                        spec.get("image") or images.TORCH_CUDA,
                        command=["python", "-m",
                                 "kubeflow_tpu_torch.serving"],
                        args=args,
                        ports={"rest": REST_PORT},
                        resources=images.gpu_resources(gpus),
                    )
                ],
                "restartPolicy": "Never",
            }
        }
        job = {
            "apiVersion": jobs_api.JOBS_API_VERSION,
            "kind": jobs_api.JAX_JOB_KIND,
            "metadata": k8s.metadata(
                self.actors_name(name), ns,
                {RLJOB_LABEL: name, ROLE_LABEL: "actors"}),
            "spec": {
                "replicaSpecs": {
                    "Worker": {"replicas": replicas,
                               "restartPolicy": "OnFailure",
                               "template": template}
                },
                # LOW priority + preemptible + elastic: the first
                # capacity the scheduler reclaims, shrunk live before
                # killed, and rollouts resume on whatever the next
                # weight push finds.
                "priority": int(actors.get(
                    "priority", DEFAULT_ACTOR_PRIORITY)),
                "preemptible": True,
                # The floor is raised to the pod count: a JaxJob's
                # elastic minReplicas may not fall below its processes
                # (validate_job), and the scheduler's floor is that
                # count already. JAX writes minReplicas as given, so its
                # job controller fails the actor gang (InvalidSpec)
                # whenever minReplicas < replicas.
                "elastic": {"minReplicas": max(lo, replicas),
                            "maxReplicas": max(hi, lo)},
                "runPolicy": {"cleanPodPolicy": "Running"},
            },
        }
        if actors.get("queue"):
            job["spec"]["queue"] = actors["queue"]
        if spec.get("tpu"):
            job["spec"]["tpu"] = dict(spec["tpu"])
        return job

    # -- reconcile -----------------------------------------------------

    def reconcile(self, rl: dict) -> None:
        rl = copy.deepcopy(rl)
        name = rl["metadata"]["name"]
        ns = rl["metadata"]["namespace"]
        try:
            validate_rl_job(rl)
        except RLJobValidationError as e:
            rl["status"] = {**(rl.get("status") or {}),
                            "phase": "Failed", "reason": str(e)}
            self._push_status(rl)
            return
        ref = k8s.object_ref(rl)
        children = []
        for child in (self._learner_job(rl), self._actors_job(rl)):
            child["metadata"]["ownerReferences"] = [ref]
            existing = self.client.get_or_none(
                child["apiVersion"], child["kind"],
                child["metadata"]["name"], ns)
            if existing is None:
                self.client.create(child)
                children.append(child)
            else:
                if existing.get("spec") != child["spec"]:
                    existing["spec"] = child["spec"]
                    existing = self.client.update(existing) or existing
                children.append(existing)
        status = {
            "phase": _phase_of(children),
            "learner": {
                "job": self.learner_name(name),
                "state": ((children[0].get("status") or {})
                          .get("state") or "Pending"),
            },
            "actors": {
                "job": self.actors_name(name),
                "state": ((children[1].get("status") or {})
                          .get("state") or "Pending"),
                "replicas": int((rl["spec"].get("actors") or {})
                                .get("replicas", 2)),
            },
        }
        # Surface the learner's published metrics (train.rl publishes
        # into its job status as every training loop does) so one
        # kubectl get shows the loop's weight-push progress.
        learner_metrics = ((children[0].get("status") or {})
                           .get("metrics") or {})
        if "weights_version" in learner_metrics:
            status["weightsVersion"] = int(
                learner_metrics["weights_version"])
        rl["status"] = {**(rl.get("status") or {}), **status}
        self._push_status(rl)
