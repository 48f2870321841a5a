"""The training-job controller; a copy of ``kubeflow_tpu/operators/jobs.py``
(one controller a kind: JaxJob, TFJob, PyTorchJob, MXNetJob, ChainerJob,
MPIJob) that places pods on GPU nodes.

Kept from JAX's: gang creation (every replica pod in one pass), stable
DNS under a per-job headless Service (``{job}-{type}-{i}.{job}.{ns}``),
the status conditions and per-replica counters, the restart policies
(Never/OnFailure/ExitCode/Always), the JaxJob gang restart,
``backoffLimit``, ``activeDeadlineSeconds``, ``cleanPodPolicy``,
``ttlSecondsAfterFinished``, and preemption handling (a preempted gang
reschedules without spending its backoff). A scheduler-managed job
(``spec.priority`` or ``spec.queue``) gets no pod until the cluster
scheduler's placement annotation names a host for each (an elastic
grant may name more; pods sit on its prefix).

The mapping from JAX's: a placed pod gets ``nodeName`` and the GPU
selector ``{"cloud.google.com/gke-accelerator": <pool>}`` where JAX pins
the TPU accelerator and topology; an unmanaged job with
``spec.tpu.accelerator`` gets the same GPU selector. The rendezvous env
is JAX's without the ``TPU_*`` keys (``TPU_WORKER_HOSTNAMES``,
``TPU_WORKER_ID``, the accelerator and the topology), which nothing of
the port reads; ``parallel/distributed.py`` reads the rest.
"""

from __future__ import annotations

import copy
import datetime
import json

from kubeflow_tpu_torch.apis import jobs as api
from kubeflow_tpu_torch.apis import scheduling as sched_api
from kubeflow_tpu_torch.k8s_client import ApiError
from kubeflow_tpu_torch.manifests import objects as k8s
from kubeflow_tpu_torch.operators.base import Controller

POD_API = "v1"
LABEL_JOB = "kubeflow-tpu.org/job-name"
LABEL_KIND = "kubeflow-tpu.org/job-kind"
LABEL_REPLICA_TYPE = "kubeflow-tpu.org/replica-type"
LABEL_REPLICA_INDEX = "kubeflow-tpu.org/replica-index"

# GKE's GPU node label: the pool a pod is pinned to.
GKE_GPU_ACCEL_SELECTOR = sched_api.NODE_ACCEL_LABEL

# Replica type whose completion defines job success, in priority order (the
# tf-operator convention: chief/master if present, else workers).
_COMPLETION_PRIORITY = ("Chief", "Master", "Launcher", "Scheduler", "Worker")


def _now() -> str:
    return (
        datetime.datetime.now(datetime.timezone.utc)
        .replace(microsecond=0)
        .isoformat()
        .replace("+00:00", "Z")
    )


def _parse_time(ts: str) -> datetime.datetime:
    return datetime.datetime.fromisoformat(ts.replace("Z", "+00:00"))


class JobController(Controller):
    api_version = api.JOBS_API_VERSION
    resync_seconds = 10.0

    def __init__(self, client, kind: str = api.JAX_JOB_KIND):
        super().__init__(client)
        self.kind = kind

    # ------------------------------------------------------------------
    # reconcile
    # ------------------------------------------------------------------

    def reconcile(self, job: dict) -> None:
        job = copy.deepcopy(job)
        status = job.setdefault("status", {})
        state = status.get("state")

        if state in ("Succeeded", "Failed"):
            return self._handle_finished(job)

        try:
            api.validate_job(job)
        except api.JobValidationError as e:
            self._finish(job, "Failed", "InvalidSpec", str(e))
            return

        if not status.get("startTime"):
            status["startTime"] = _now()
            self._set_condition(job, api.COND_CREATED, "JobCreated",
                                f"{self.kind} created")

        self._ensure_service(job)
        pods = self._ensure_pods(job)
        self._update_status(job, pods)

    # ------------------------------------------------------------------
    # children
    # ------------------------------------------------------------------

    def _ensure_service(self, job: dict) -> None:
        name = job["metadata"]["name"]
        ns = job["metadata"]["namespace"]
        if self.client.get_or_none(POD_API, "Service", name, ns):
            return
        svc = k8s.headless_service(
            name=name,
            namespace=ns,
            selector={LABEL_JOB: name},
            ports=[{"name": "coordinator",
                    "port": api.DEFAULT_COORDINATOR_PORT}],
            labels={LABEL_JOB: name, LABEL_KIND: self.kind},
        )
        svc["metadata"]["ownerReferences"] = [k8s.object_ref(job)]
        self.client.create(svc)

    def _pod_name(self, job_name: str, rt: str, index: int) -> str:
        return f"{job_name}-{rt.lower()}-{index}"

    def _list_pods(self, job: dict) -> list[dict]:
        return self.client.list(
            POD_API, "Pod", job["metadata"]["namespace"],
            label_selector={LABEL_JOB: job["metadata"]["name"]},
        )

    def _rspec_for_pod(self, job: dict, pod: dict) -> dict:
        rt_label = pod["metadata"]["labels"].get(LABEL_REPLICA_TYPE, "")
        return next(
            (rs for rt, rs in job["spec"]["replicaSpecs"].items()
             if rt.lower() == rt_label), {},
        )

    def _gang_restart_if_needed(self, job: dict, existing: dict) -> dict:
        """JaxJob restart is all-or-nothing: a lone restarted process cannot
        rejoin a completed process-group rendezvous, so a retryable worker
        failure restarts the whole gang. Pods in phase Unknown (node
        unreachable) count as failed: waiting for the kubelet to come
        back would hang the collective."""
        failed = [p for p in existing.values()
                  if p.get("status", {}).get("phase") in ("Failed",
                                                          "Unknown")]
        retryable = [
            self._should_restart(
                p, self._rspec_for_pod(job, p).get("restartPolicy",
                                                   "OnFailure"))
            for p in failed
        ]
        # A permanently-failed replica must surface as ReplicaFailed in
        # _update_status, not be swallowed by a gang recreate.
        if not failed or not all(retryable):
            return existing
        ns = job["metadata"]["namespace"]
        for pod_name in existing:
            self.client.delete_if_exists(POD_API, "Pod", pod_name, ns)
        preempted = all(self._is_preempted(p) for p in failed)
        self._bump_restarts(job, preempted=preempted)
        self._set_condition(
            job, api.COND_RESTARTING,
            "GangPreempted" if preempted else "GangRestarting",
            ("slice preempted; rescheduling the gang"
             if preempted else
             "worker failed; restarting the whole gang (collective "
             "rendezvous is all-or-nothing)"),
        )
        return {}

    def _ensure_pods(self, job: dict) -> list[dict]:
        """Create missing pods (gang: all in one pass); handle restarts."""
        name = job["metadata"]["name"]
        ns = job["metadata"]["namespace"]
        existing = {p["metadata"]["name"]: p for p in self._list_pods(job)}
        if self.kind == api.JAX_JOB_KIND:
            existing = self._gang_restart_if_needed(job, existing)
        desired = []
        for rt, rspec in job["spec"]["replicaSpecs"].items():
            for i in range(rspec.get("replicas", 1)):
                desired.append((rt, i, rspec))

        # Scheduler-managed jobs (spec.priority/queue) create NO pods until
        # the cluster scheduler has reserved a full slice for the gang —
        # the placement annotation IS the reservation, so a gang is either
        # fully creatable or fully parked (all-or-nothing admission).
        managed = sched_api.is_managed(job)
        decided = sched_api.placement(job) if managed else None
        if managed and decided is not None:
            nodes = decided.get("nodes", [])
            if sched_api.elastic_spec(job) is not None:
                # Elastic grant: pods sit on the PREFIX of the granted
                # hosts; the grant may exceed the pod count (the extra
                # hosts are accelerator width the training loop meshes
                # over). Only a grant too small to seat every process
                # parks the gang — a shrink/grow rewrite above the pod
                # count must NOT churn pods, that is the whole point.
                if len(nodes) < len(desired):
                    decided = None
            elif len(nodes) != len(desired):
                decided = None  # stale reservation (gang size changed)

        pods = []
        for idx, (rt, i, rspec) in enumerate(desired):
            pod_name = self._pod_name(name, rt, i)
            pod = existing.get(pod_name)
            if pod is not None:
                phase = pod.get("status", {}).get("phase", "Pending")
                restart = rspec.get("restartPolicy", "OnFailure")
                # JaxJob restarts only as a whole gang (handled above): a
                # solo-recreated worker can't rejoin the collective, and a
                # declined gang restart must not churn pods or restartCount.
                if (phase == "Failed" and self.kind != api.JAX_JOB_KIND
                        and self._should_restart(pod, restart)):
                    self.client.delete(POD_API, "Pod", pod_name, ns)
                    self._bump_restarts(job, preempted=self._is_preempted(pod))
                    self._set_condition(
                        job, api.COND_RESTARTING, "PodRestarting",
                        f"replica {rt}/{i} restarting",
                    )
                    pod = None
                else:
                    pods.append(pod)
                    continue
            if managed and decided is None:
                continue  # queued: awaiting (re-)admission
            pod = self._build_pod(job, rt, i, rspec,
                                  placement=decided,
                                  node=(decided["nodes"][idx]
                                        if decided else None))
            try:
                pods.append(self.client.create(pod))
            except ApiError as e:
                if e.code != 409:
                    raise
        return pods

    @staticmethod
    def _is_preempted(pod: dict) -> bool:
        """Node preemption/shutdown killed the pod — an infrastructure
        event, not a workload failure. Signals: the kubelet's graceful-
        shutdown reasons on pod status, or the DisruptionTarget condition
        the eviction API sets. Spot or reserved reclaims take whole hosts
        at once, and the gang must reschedule (resuming from checkpoint)
        rather than burn its backoffLimit."""
        status = pod.get("status", {})
        if status.get("reason") in ("Preempted", "Shutdown", "Terminated",
                                    "NodeShutdown"):
            return True
        if any(
            c.get("type") == "DisruptionTarget" and c.get("status") == "True"
            for c in status.get("conditions", [])
        ):
            return True
        # Scheduler-initiated eviction: the cluster scheduler marks each
        # victim pod BEFORE delivering the SIGTERM, so the accounting
        # (preemptionCount, backoffLimit untouched) is correct even when
        # the pod's final phase carries no kubelet reason string.
        return bool(pod.get("metadata", {}).get("annotations", {}).get(
            sched_api.ANN_PREEMPTED_BY))

    def _should_restart(self, pod: dict, restart_policy: str) -> bool:
        if self._is_preempted(pod):
            return True  # preemption is always retryable, any policy
        if restart_policy in ("Always", "OnFailure"):
            return True
        if restart_policy == "ExitCode":
            # Retryable iff the main container exited nonzero with a
            # retryable code (SIGKILL'd / infra codes 128+ retry; 1-127 are
            # permanent — the tf-operator ExitCode contract).
            for cs in pod.get("status", {}).get("containerStatuses", []):
                code = cs.get("state", {}).get("terminated", {}).get("exitCode")
                if code is not None:
                    return code > 127
            return True
        return False

    def _bump_restarts(self, job: dict, *, preempted: bool = False) -> None:
        # Preemptions are tracked separately and do not count against
        # runPolicy.backoffLimit — infrastructure churn must not fail jobs.
        key = "preemptionCount" if preempted else "restartCount"
        job["status"][key] = job["status"].get(key, 0) + 1

    # ------------------------------------------------------------------
    # pod construction + env injection
    # ------------------------------------------------------------------

    def _build_pod(self, job: dict, rt: str, index: int, rspec: dict,
                   placement: dict | None = None,
                   node: str | None = None) -> dict:
        name = job["metadata"]["name"]
        ns = job["metadata"]["namespace"]
        pod = copy.deepcopy(rspec["template"])
        pod.setdefault("apiVersion", POD_API)
        pod.setdefault("kind", "Pod")
        meta = pod.setdefault("metadata", {})
        meta["name"] = self._pod_name(name, rt, index)
        meta["namespace"] = ns
        labels = meta.setdefault("labels", {})
        labels.update({
            LABEL_JOB: name,
            LABEL_KIND: self.kind,
            LABEL_REPLICA_TYPE: rt.lower(),
            LABEL_REPLICA_INDEX: str(index),
        })
        meta["ownerReferences"] = [k8s.object_ref(job)]
        spec = pod.setdefault("spec", {})
        # Stable DNS via the job's headless service.
        spec["hostname"] = meta["name"]
        spec["subdomain"] = name
        spec.setdefault("restartPolicy", "Never")

        if placement is not None:
            # Cluster-scheduler decision: this pod is pinned to its
            # reserved host in its pool.
            ann = meta.setdefault("annotations", {})
            ann[sched_api.ANN_POOL] = placement.get("pool", "")
            ann[sched_api.ANN_SLICE] = placement.get("slice", "")
            if node:
                spec["nodeName"] = node
            sel = spec.setdefault("nodeSelector", {})
            sel[GKE_GPU_ACCEL_SELECTOR] = placement.get("pool", "")
        else:
            # spec.tpu keeps JAX's name; its accelerator is the GPU pool.
            tpu = job["spec"].get("tpu", {})
            if tpu.get("accelerator"):
                sel = spec.setdefault("nodeSelector", {})
                sel[GKE_GPU_ACCEL_SELECTOR] = tpu["accelerator"]

        env = self._rendezvous_env(job, rt, index)
        for container in spec.get("containers", []):
            existing = {e["name"] for e in container.setdefault("env", [])}
            container["env"].extend(
                {"name": k, "value": str(v)}
                for k, v in env.items() if k not in existing
            )
        return pod

    def _host(self, job_name: str, ns: str, rt: str, index: int) -> str:
        return f"{self._pod_name(job_name, rt, index)}.{job_name}.{ns}"

    def _replica_hosts(self, job: dict, rt: str, port: int | None = None):
        name = job["metadata"]["name"]
        ns = job["metadata"]["namespace"]
        n = job["spec"]["replicaSpecs"].get(rt, {}).get("replicas", 0)
        suffix = f":{port}" if port else ""
        return [f"{self._host(name, ns, rt, i)}{suffix}" for i in range(n)]

    def _rendezvous_env(self, job: dict, rt: str, index: int) -> dict:
        """Per-framework cluster env — the TF_CONFIG analogue family."""
        port = api.DEFAULT_COORDINATOR_PORT
        name = job["metadata"]["name"]
        ns = job["metadata"]["namespace"]
        specs = job["spec"]["replicaSpecs"]
        kind = self.kind

        common = {
            api.ENV_JOB_NAME: name,
            api.ENV_JOB_NAMESPACE: ns,
            api.ENV_JOB_KIND: kind,
        }

        if kind == api.JAX_JOB_KIND:
            workers = self._replica_hosts(job, "Worker")
            num_slices = job["spec"].get("tpu", {}).get("numSlices", 1)
            hosts_per_slice = max(len(workers) // max(num_slices, 1), 1)
            env = {
                api.ENV_COORDINATOR_ADDRESS:
                    f"{self._host(name, ns, 'Worker', 0)}:{port}",
                api.ENV_COORDINATOR_PORT: port,
                api.ENV_NUM_PROCESSES: len(workers),
                api.ENV_PROCESS_ID: index,
            }
            if num_slices > 1:
                env[api.ENV_NUM_SLICES] = num_slices
                env[api.ENV_SLICE_ID] = index // hosts_per_slice
                env["MEGASCALE_COORDINATOR_ADDRESS"] = (
                    f"{self._host(name, ns, 'Worker', 0)}"
                )
            return common | env

        if kind == api.TF_JOB_KIND:
            cluster = {
                t.lower(): self._replica_hosts(job, t, port)
                for t in ("Chief", "PS", "Worker", "Evaluator") if t in specs
            }
            return common | {"TF_CONFIG": json.dumps({
                "cluster": cluster,
                "task": {"type": rt.lower(), "index": index},
            })}

        if kind == api.PYTORCH_JOB_KIND:
            n_workers = specs.get("Worker", {}).get("replicas", 0)
            return common | {
                "MASTER_ADDR": self._host(name, ns, "Master", 0),
                "MASTER_PORT": port,
                "WORLD_SIZE": 1 + n_workers,
                "RANK": 0 if rt == "Master" else index + 1,
            }

        if kind == api.MXNET_JOB_KIND:
            return common | {
                "DMLC_PS_ROOT_URI": self._host(name, ns, "Scheduler", 0),
                "DMLC_PS_ROOT_PORT": port,
                "DMLC_ROLE": rt.lower(),
                "DMLC_NUM_SERVER": specs.get("Server", {}).get("replicas", 0),
                "DMLC_NUM_WORKER": specs.get("Worker", {}).get("replicas", 0),
                "DMLC_WORKER_ID" if rt == "Worker" else "DMLC_SERVER_ID": index,
            }

        if kind == api.CHAINER_JOB_KIND:
            workers = self._replica_hosts(job, "Worker")
            return common | {
                "CHAINERMN_MASTER_ADDR": self._host(name, ns, "Master", 0),
                "CHAINERMN_MASTER_PORT": port,
                "CHAINERMN_NUM_PROCESSES": 1 + len(workers),
                "CHAINERMN_PROCESS_ID": 0 if rt == "Master" else index + 1,
            }

        if kind == api.MPI_JOB_KIND:
            # kubectl-delivery analogue: hostfile content via env (the
            # launcher writes it to disk), one slot per worker.
            workers = self._replica_hosts(job, "Worker")
            return common | {
                "OMPI_MCA_orte_default_hostfile": "/etc/mpi/hostfile",
                "MPI_HOSTFILE_CONTENT": "\n".join(
                    f"{w} slots=1" for w in workers
                ),
                "OMPI_MCA_orte_keep_fqdn_hostnames": "true",
            }

        raise ValueError(f"unknown kind {kind}")

    # ------------------------------------------------------------------
    # status
    # ------------------------------------------------------------------

    def _completion_replica_type(self, job: dict) -> str:
        specs = job["spec"]["replicaSpecs"]
        for rt in _COMPLETION_PRIORITY:
            if rt in specs and specs[rt].get("replicas", 1) > 0:
                return rt
        return next(iter(specs))

    def _update_status(self, job: dict, pods: list[dict]) -> None:
        status = job["status"]
        counts: dict[str, dict[str, int]] = {}
        for pod in pods:
            rt = pod["metadata"]["labels"].get(LABEL_REPLICA_TYPE, "")
            phase = pod.get("status", {}).get("phase", "Pending")
            bucket = {"Running": "active", "Succeeded": "succeeded",
                      "Failed": "failed"}.get(phase, "pending")
            by_bucket = counts.setdefault(rt, {})
            by_bucket[bucket] = by_bucket.get(bucket, 0) + 1
        status["replicaStatuses"] = counts

        run_policy = job["spec"].get("runPolicy", {})

        # Deadline.
        deadline = run_policy.get("activeDeadlineSeconds")
        if deadline and status.get("startTime"):
            age = (
                datetime.datetime.now(datetime.timezone.utc)
                - _parse_time(status["startTime"])
            ).total_seconds()
            if age > deadline:
                self._finish(job, "Failed", "DeadlineExceeded",
                             f"job ran longer than {deadline}s")
                return

        # Failure: a permanently-failed pod, or restart budget exhausted.
        backoff = run_policy.get("backoffLimit")
        if backoff is not None and status.get("restartCount", 0) > backoff:
            self._finish(job, "Failed", "BackoffLimitExceeded",
                         f"restarts exceeded backoffLimit={backoff}")
            return
        for pod in pods:
            if pod.get("status", {}).get("phase") != "Failed":
                continue
            rspec = self._rspec_for_pod(job, pod)
            if not self._should_restart(
                pod, rspec.get("restartPolicy", "OnFailure")
            ):
                self._finish(
                    job, "Failed", "ReplicaFailed",
                    f"pod {pod['metadata']['name']} failed permanently",
                )
                return

        # Success: every pod of the completion replica type succeeded.
        crt = self._completion_replica_type(job).lower()
        want = job["spec"]["replicaSpecs"][
            self._completion_replica_type(job)
        ].get("replicas", 1)
        done = counts.get(crt, {}).get("succeeded", 0)
        if want and done >= want:
            self._finish(job, "Succeeded", "JobSucceeded",
                         f"all {crt} replicas succeeded")
            return

        if any(
            p.get("status", {}).get("phase") == "Running" for p in pods
        ) and status.get("state") != "Running":
            status["state"] = "Running"
            self._set_condition(job, api.COND_RUNNING, "JobRunning",
                                "replicas are running")
        self._push_status(job)

    def _finish(self, job: dict, state: str, reason: str, message: str) -> None:
        job["status"]["state"] = state
        job["status"]["completionTime"] = _now()
        cond = api.COND_SUCCEEDED if state == "Succeeded" else api.COND_FAILED
        self._set_condition(job, cond, reason, message)
        self._push_status(job)
        self._clean_pods(job)

    def _handle_finished(self, job: dict) -> float | None:
        ttl = job["spec"].get("runPolicy", {}).get("ttlSecondsAfterFinished")
        if ttl is None:
            return None
        done_at = job["status"].get("completionTime")
        if not done_at:
            return None
        age = (
            datetime.datetime.now(datetime.timezone.utc)
            - _parse_time(done_at)
        ).total_seconds()
        if age >= ttl:
            self.client.delete_if_exists(
                self.api_version, self.kind, job["metadata"]["name"],
                job["metadata"]["namespace"],
            )
            return None
        # Requeue-after: wake exactly when the TTL lapses instead of
        # burning resync passes until then.
        return max(ttl - age, 0.1)

    def _clean_pods(self, job: dict) -> None:
        policy = job["spec"].get("runPolicy", {}).get("cleanPodPolicy",
                                                      "Running")
        if policy == "None":
            return
        for pod in self._list_pods(job):
            phase = pod.get("status", {}).get("phase", "Pending")
            if policy == "All" or phase in ("Running", "Pending"):
                self.client.delete_if_exists(
                    POD_API, "Pod", pod["metadata"]["name"],
                    pod["metadata"]["namespace"],
                )

    # Status writes go through Controller._push_status (refetch-and-reapply
    # on conflict): a reconcile racing the watch-driven requeue must not
    # park the job until the next resync.

    # Condition types the cluster scheduler owns: the lifecycle flip
    # below must not clobber them (the scheduler sets/clears its own).
    _SCHEDULER_CONDITIONS = (sched_api.COND_QUEUED,
                             sched_api.COND_UNSCHEDULABLE)

    def _set_condition(self, job: dict, ctype: str, reason: str,
                       message: str) -> None:
        conds = job["status"].setdefault("conditions", [])
        for c in conds:
            if c["type"] in self._SCHEDULER_CONDITIONS:
                continue
            c["status"] = "False" if c["type"] != ctype else c["status"]
        existing = next((c for c in conds if c["type"] == ctype), None)
        if existing and existing["status"] == "True":
            return
        cond = api.Condition(
            type=ctype, status="True", reason=reason, message=message,
            last_transition_time=_now(),
        ).to_dict()
        if existing:
            conds[conds.index(existing)] = cond
        else:
            conds.append(cond)
        if ctype == api.COND_CREATED:
            job["status"].setdefault("state", "Created")
        elif ctype in (api.COND_RUNNING, api.COND_RESTARTING):
            job["status"]["state"] = ctype

def make_job_controllers(client) -> list[JobController]:
    return [JobController(client, kind) for kind in api.ALL_JOB_KINDS]
