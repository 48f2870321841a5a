"""``gpu-scheduler``: the cluster scheduler's CRD, default policy, RBAC and
Deployment on the port; counterpart of
``kubeflow_tpu/manifests/packages/scheduling.py``'s ``scheduler``.

The Deployment runs ``python -m kubeflow_tpu_torch.scheduler`` on the
port's image with no GPU: the placement authority for every training-job
kind over the cluster's GPU pools. It replaces JAX's scheduler on a GPU
cluster (two schedulers must not place the same jobs). With ``replicas``
above 1 the replicas elect a leader on the Lease ``scheduler``
(``--leader-elect --leader-elect-name scheduler``, as JAX renders).
"""

from __future__ import annotations

from kubeflow_tpu_torch.apis import API_GROUP
from kubeflow_tpu_torch.apis import jobs as jobs_api
from kubeflow_tpu_torch.apis import scheduling as sched_api
from kubeflow_tpu_torch.manifests import images
from kubeflow_tpu_torch.manifests import objects as k8s
from kubeflow_tpu_torch.manifests.core import (
    DEFAULT_NAMESPACE,
    ParamSpec,
    prototype,
)


@prototype(
    "gpu-scheduler",
    "SchedulingPolicy CRD + default policy + the port's cluster-scheduler "
    "Deployment and RBAC (gang placement over GPU pools, priorities, "
    "preemption; scheduler's counterpart)",
    params=[
        ParamSpec("namespace", DEFAULT_NAMESPACE),
        ParamSpec("image", images.TORCH_CUDA),
        ParamSpec("replicas", 1, "scheduler replicas (leader-elected)"),
        ParamSpec("scheduling_period_seconds", 5,
                  "queue scan cadence (a round a period)"),
        ParamSpec("aging_seconds", 300,
                  "queue-wait seconds worth one priority point "
                  "(starvation aging; 0 disables)"),
        ParamSpec("preemption_enabled", True,
                  "higher-priority gangs may evict lower-priority ones"),
        ParamSpec("requeue_backoff_seconds", 10,
                  "delay before a preempted gang is eligible again"),
        ParamSpec("grace_period_seconds", 30,
                  "SIGTERM-to-SIGKILL eviction grace (the checkpoint "
                  "window)"),
    ],
)
def gpu_scheduler(
    namespace: str,
    image: str,
    replicas: int,
    scheduling_period_seconds: int,
    aging_seconds: int,
    preemption_enabled: bool,
    requeue_backoff_seconds: int,
    grace_period_seconds: int,
) -> list[dict]:
    name = "scheduler"
    labels = {"app": name, "app.kubernetes.io/part-of": "kubeflow-tpu"}
    objs: list[dict] = [sched_api.scheduling_policy_crd()]
    objs.append(sched_api.scheduling_policy(
        "default", namespace,
        schedulingPeriodSeconds=scheduling_period_seconds,
        agingSeconds=aging_seconds,
        preemption={
            "enabled": preemption_enabled,
            "requeueBackoffSeconds": requeue_backoff_seconds,
            "gracePeriodSeconds": grace_period_seconds,
        },
    ))
    objs.append(k8s.service_account(name, namespace, labels))
    rules = [
        # Placement decisions: annotation patches + status.scheduling
        # on every job kind, and the policy it reconciles.
        k8s.policy_rule(
            [API_GROUP],
            list(jobs_api.PLURALS.values())
            + [f"{p}/status" for p in jobs_api.PLURALS.values()]
            + [sched_api.SCHEDULING_POLICY_PLURAL,
               f"{sched_api.SCHEDULING_POLICY_PLURAL}/status"],
            ["*"],
        ),
        # Victim marking + evictions; nodes feed the capacity model.
        k8s.policy_rule([""], ["pods", "pods/status", "pods/eviction",
                               "events"], ["*"]),
        k8s.policy_rule([""], ["nodes"], ["get", "list", "watch"]),
        k8s.policy_rule(["coordination.k8s.io"], ["leases"],
                        ["get", "list", "watch", "create", "update"]),
    ]
    objs.append(k8s.cluster_role(name, rules, labels))
    objs.append(k8s.cluster_role_binding(name, name, name, namespace))
    objs.append(
        k8s.deployment(
            name,
            namespace,
            containers=[
                k8s.container(
                    name,
                    image,
                    command=["python", "-m", "kubeflow_tpu_torch.scheduler"],
                    args=["--alsologtostderr", "-v=1"]
                    + (["--leader-elect", "--leader-elect-name", name]
                       if replicas > 1 else []),
                    ports={"metrics": 8444},
                )
            ],
            replicas=replicas,
            labels=labels,
            service_account=name,
            # The scheduler's decision metrics (queue depth and wait,
            # placement latency, preemptions, requeues) and the operator
            # runtime's, on :8444.
            pod_annotations={
                "prometheus.io/scrape": "true",
                "prometheus.io/path": "/metrics",
                "prometheus.io/port": "8444",
            },
        )
    )
    return objs
