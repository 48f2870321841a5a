"""The heterogeneity-aware gang scheduler (the Gavel-style policy loop); a
copy of ``kubeflow_tpu/scheduler/controller.py`` over GPU nodes.

``SchedulerController`` owns placement for every training-job kind. It
reconciles the cluster's ``SchedulingPolicy`` object, and **one
reconcile is one scheduling round** over a consistent snapshot:

1. rebuild the capacity model from Nodes (GPU pools of slices; dead or
   cordoned nodes are not capacity);
2. derive occupancy from live placements and still-running pods (never
   stored: a scheduler restart recovers by reading the world);
3. order the queue: weighted fair share across queues, then priority +
   starvation aging, then FIFO;
4. admit gangs **all-or-nothing**: a gang gets one placement annotation
   naming a host a pod on ONE slice, or stays queued;
5. reclaim an elastic job's grant above its floor before preempting, and
   preempt when a higher-priority gang still cannot fit: victims get the
   ``preempted-by`` mark on the job and each pod, then the evictor marks
   each pod Failed (reason Preempted, DisruptionTarget) through the
   client, as an eviction shows on the apiserver;
6. grow elastic grants into capacity left idle.

It runs on the port's polling runtime (``operators/base.py``), which has
no watch: where JAX's controller requeues its policy on every job, pod
and node event, the port's rounds come at the policy's period (the
requeue each round returns) and the resync. Decisions are exported in
the shared operator registry under JAX's family names.
"""

from __future__ import annotations

import datetime
import logging
import time
from typing import Callable, Mapping

from kubeflow_tpu_torch.apis import jobs as jobs_api
from kubeflow_tpu_torch.apis import scheduling as api
from kubeflow_tpu_torch.k8s_client import K8sClient, retry_on_conflict
from kubeflow_tpu_torch.operators.base import OPERATOR_METRICS, Controller
from kubeflow_tpu_torch.scheduler.capacity import (
    ClusterCapacity,
    ThroughputBook,
)
from kubeflow_tpu_torch.scheduler.queue import (
    QueueEntry,
    order_queue,
    parse_time,
)

log = logging.getLogger(__name__)

POD_API = "v1"

# Scheduler decision metrics, in the shared operator registry so ONE
# scrape of the manager's /metrics sees queue health next to the runtime
# signals (and the single-renderer invariant holds).
M_QUEUE_DEPTH = OPERATOR_METRICS.gauge(
    "scheduler_queue_depth",
    "Gangs queued (unplaced), by queue", labels=("queue",))
M_QUEUE_WAIT = OPERATOR_METRICS.histogram(
    "scheduler_queue_wait_seconds",
    "Queue wait from first sight to admission, by queue",
    labels=("queue",))
M_PLACEMENT = OPERATOR_METRICS.histogram(
    "scheduler_placement_seconds",
    "Latency of one placement decision (snapshot to annotation write)")
M_ADMISSIONS = OPERATOR_METRICS.counter(
    "scheduler_admissions_total",
    "Gangs admitted, by pool", labels=("pool",))
M_PREEMPTIONS = OPERATOR_METRICS.counter(
    "scheduler_preemptions_total",
    "Gangs preempted, by reason", labels=("reason",))
M_REQUEUES = OPERATOR_METRICS.counter(
    "scheduler_requeues_total",
    "Placed gangs sent back to the queue, by reason", labels=("reason",))
M_UNSCHEDULABLE = OPERATOR_METRICS.gauge(
    "scheduler_unschedulable_jobs",
    "Jobs whose request can never fit the current pools")
M_SHRINKS = OPERATOR_METRICS.counter(
    "scheduler_shrinks_total",
    "Elastic jobs shrunk (placement rewritten) to seat a queued gang")
M_GROWS = OPERATOR_METRICS.counter(
    "scheduler_grows_total",
    "Elastic jobs grown into idle capacity")


def _now_dt() -> datetime.datetime:
    return datetime.datetime.now(datetime.timezone.utc)


def _iso(dt: datetime.datetime) -> str:
    return dt.replace(microsecond=0).isoformat().replace("+00:00", "Z")


def _job_key(job: Mapping) -> tuple[str, str, str]:
    m = job["metadata"]
    return (job["kind"], m.get("namespace", ""), m["name"])


def _key_str(key: tuple[str, str, str]) -> str:
    return "/".join(key)


def _gang_hosts(job: Mapping) -> int:
    """Gang size in hosts: one pod a host."""
    return sum(rs.get("replicas", 1)
               for rs in job.get("spec", {}).get("replicaSpecs", {}).values())


class SchedulerController(Controller):
    """Cluster scheduler as a controller over SchedulingPolicy."""

    api_version = api.SCHEDULING_API_VERSION
    kind = api.SCHEDULING_POLICY_KIND
    resync_seconds = 5.0

    def __init__(self, client: K8sClient, *,
                 evict: Callable[[dict, float], bool] | None = None):
        super().__init__(client)
        # Pluggable eviction; the default is what an eviction looks like
        # from the apiserver: pod Failed, reason Preempted,
        # DisruptionTarget.
        self._evict = evict or self._default_evict

    # ------------------------------------------------------------------
    # one scheduling round
    # ------------------------------------------------------------------

    def reconcile(self, policy: dict) -> float | None:
        knobs = api.policy_knobs(policy)
        now = _now_dt()

        capacity = ClusterCapacity.from_nodes(
            self.client.list(POD_API, "Node"))
        book = ThroughputBook(knobs["profiles"])
        jobs = self._managed_jobs()
        pods_by_job, pod_nodes = self._pod_occupancy()

        placed, queue, used_share = self._partition(
            jobs, capacity, pods_by_job, now, knobs)
        # Hosts held by pods that outlive their (revoked) placement keep
        # the hosts busy until the processes actually exit.
        for node, holder in pod_nodes.items():
            capacity.occupy([node], holder)

        # Preemptions in flight: a job marked preempted-by whose pods are
        # still alive. Its preemptor must not evict MORE victims, and the
        # eviction itself is retried level-triggered — a transiently
        # failed SIGTERM delivery last round must not leave the victim
        # running forever on revoked hosts.
        pending_preemptors = set()
        for job in jobs:
            preemptor = job["metadata"].get("annotations", {}).get(
                api.ANN_PREEMPTED_BY)
            alive = pods_by_job.get(_job_key(job))
            if not preemptor or not alive:
                continue
            pending_preemptors.add(preemptor)
            if api.placement(job) is None:
                self._evict_pods(job, alive, preemptor, knobs)

        depth: dict[str, int] = {}
        unschedulable = 0
        waiting = 0         # fits-someday gangs still queued this round
        resized: set[str] = set()  # jobs shrunk this round: never ALSO
        #                            evicted, and never regrown, in it
        for entry in order_queue(queue, now,
                                 aging_seconds=knobs["aging_seconds"],
                                 queue_weights=knobs["queue_weights"],
                                 used_share=used_share):
            depth[entry.queue] = depth.get(entry.queue, 0) + 1
            t0 = time.perf_counter()
            if not capacity.ever_fits(entry.hosts, entry.accelerator):
                unschedulable += 1
                self._mark_unschedulable(entry, capacity)
                continue
            feasible = capacity.feasible(entry.hosts, entry.accelerator)
            if feasible:
                self._admit(entry, feasible, capacity, book, now)
                M_PLACEMENT.observe(time.perf_counter() - t0)
                depth[entry.queue] -= 1
                continue
            in_backoff = bool(entry.eligible_at and entry.eligible_at > now)
            is_pending = _key_str(entry.key) in pending_preemptors
            # The cheaper move first: reclaim grant above an elastic
            # victim's floor (a placement rewrite the victim absorbs at a
            # step boundary) before any SIGTERM flies.
            if (knobs["shrink_enabled"] and not in_backoff
                    and not is_pending
                    and self._try_shrink(entry, placed, capacity, book,
                                         knobs, now, resized)):
                M_PLACEMENT.observe(time.perf_counter() - t0)
                depth[entry.queue] -= 1
                continue
            waiting += 1
            if (knobs["preemption_enabled"] and not in_backoff
                    and not is_pending):
                if self._try_preempt(entry, placed, capacity,
                                     pods_by_job, knobs, now,
                                     exclude=resized):
                    pending_preemptors.add(_key_str(entry.key))

        if knobs["grow_enabled"] and not waiting:
            # Only genuinely idle capacity: a queued gang that could fit
            # this pool someday has first claim on freed hosts.
            self._grow_pass(placed, capacity, knobs, now, resized)

        for q in set(depth) | set(knobs["queue_weights"]):
            M_QUEUE_DEPTH.labels(q).set(depth.get(q, 0))
        M_UNSCHEDULABLE.set(unschedulable)
        self._push_policy_status(policy, depth, now)
        return knobs["period"]

    # ------------------------------------------------------------------
    # snapshot helpers
    # ------------------------------------------------------------------

    def _managed_jobs(self) -> list[dict]:
        out = []
        for kind in jobs_api.ALL_JOB_KINDS:
            try:
                listed = self.client.list(jobs_api.JOBS_API_VERSION, kind)
            except Exception:
                continue  # kind not registered in this cluster
            out.extend(j for j in listed if api.is_managed(j))
        return out

    def _pod_occupancy(self):
        """(job key -> alive pod names, node -> holder) from live pods."""
        pods_by_job: dict[tuple[str, str, str], list[str]] = {}
        pod_nodes: dict[str, str] = {}
        for pod in self.client.list(POD_API, "Pod"):
            phase = pod.get("status", {}).get("phase", "Pending")
            if phase in ("Succeeded", "Failed"):
                continue
            meta = pod["metadata"]
            ann = meta.get("annotations", {}) or {}
            labels = meta.get("labels", {}) or {}
            kind = labels.get("kubeflow-tpu.org/job-kind")
            owner = labels.get("kubeflow-tpu.org/job-name")
            if kind and owner:
                pods_by_job.setdefault(
                    (kind, meta.get("namespace", ""), owner),
                    []).append(meta["name"])
            node = pod.get("spec", {}).get("nodeName")
            if node and api.ANN_POOL in ann:
                pod_nodes[node] = f"pod:{meta.get('namespace','')}/" \
                                  f"{meta['name']}"
        return pods_by_job, pod_nodes

    def _partition(self, jobs, capacity: ClusterCapacity,
                   pods_by_job, now, knobs):
        """Split managed jobs into placed (occupying) and queued; revoke
        placements whose hosts vanished (node kill)."""
        placed: list[dict] = []
        queue: list[QueueEntry] = []
        used_share: dict[str, float] = {}
        live_nodes = capacity.node_names
        for job in jobs:
            state = job.get("status", {}).get("state")
            if state in ("Succeeded", "Failed"):
                continue
            key = _job_key(job)
            decided = api.placement(job)
            if decided is not None:
                if not set(decided["nodes"]) <= live_nodes:
                    # A reserved host died: the whole gang must move
                    # (contiguous-slice invariant) — revoke and requeue.
                    self._revoke(job, reason="node-lost", now=now,
                                 backoff=knobs["requeue_backoff"])
                    M_REQUEUES.labels("node-lost").inc()
                else:
                    capacity.occupy(decided["nodes"], _key_str(key))
                    placed.append(job)
                    used_share[api.job_queue(job)] = (
                        used_share.get(api.job_queue(job), 0.0)
                        + len(decided["nodes"]))
                    continue
            queue.append(self._entry(job, now))
        return placed, queue, used_share

    def _entry(self, job: dict, now) -> QueueEntry:
        sched = job.get("status", {}).get("scheduling", {}) or {}
        queued_at = now
        if sched.get("queuedAt"):
            try:
                queued_at = parse_time(sched["queuedAt"])
            except ValueError:
                pass
        else:
            self._write_scheduling(job, {
                "state": api.STATE_QUEUED, "queuedAt": _iso(now),
                "queue": api.job_queue(job),
                "priority": api.job_priority(job),
            }, condition=(api.COND_QUEUED, "True", "AwaitingCapacity",
                          "gang queued by the cluster scheduler"))
        eligible_at = None
        if sched.get("requeueAfter"):
            try:
                eligible_at = parse_time(sched["requeueAfter"])
            except ValueError:
                pass
        # spec.tpu keeps JAX's name; its accelerator is the GPU pool.
        tpu = job.get("spec", {}).get("tpu", {}) or {}
        pods = _gang_hosts(job)
        elastic = api.elastic_spec(job)
        if elastic and elastic["max"] < pods:
            # A range that cannot seat every process is malformed
            # (admission webhook validation rejects it; a scheduler must
            # not act on garbage): treat as a fixed-size gang.
            elastic = None
        # Elastic gangs admit at their floor (every process seated, at
        # least minReplicas hosts) and extend toward maxReplicas from
        # whatever the slice has free — degraded admission now beats
        # queued-at-full-size later; the grow pass recovers the rest.
        hosts = max(pods, elastic["min"]) if elastic else pods
        return QueueEntry(
            key=_job_key(job),
            priority=api.job_priority(job),
            queue=api.job_queue(job),
            hosts=hosts,
            queued_at=queued_at,
            eligible_at=eligible_at,
            accelerator=tpu.get("accelerator") or None,
            profile=job.get("spec", {}).get("profile"),
            preemptible=api.is_preemptible(job),
            elastic=elastic,
            job=job,
        )

    # ------------------------------------------------------------------
    # decisions
    # ------------------------------------------------------------------

    def _admit(self, entry: QueueEntry, feasible, capacity, book,
               now) -> None:
        """Reserve a full slice-contiguous host set and publish it as ONE
        placement annotation — the all-or-nothing write."""
        def rank(sl):
            # Highest measured throughput first (Gavel), then best-fit
            # (least leftover free hosts — keeps big slices whole), then
            # stable id for determinism.
            return (-book.score(entry.profile, sl.pool),
                    len(capacity.free_hosts(sl)) - entry.hosts,
                    sl.slice_id)

        sl = min(feasible, key=rank)
        want = entry.hosts
        if entry.elastic:
            # Opportunistic grow at admission: take whatever the chosen
            # slice has free up to maxReplicas — idle contiguous hosts
            # convert straight into data-parallel width.
            free = len(capacity.free_hosts(sl))
            want = min(max(entry.hosts, free), entry.elastic["max"])
        nodes = capacity.reserve(sl, want, _key_str(entry.key))
        kind, ns, name = entry.key
        elastic_grant = None
        if entry.elastic:
            elastic_grant = {"granted": len(nodes),
                             "min": entry.elastic["min"],
                             "max": entry.elastic["max"]}
        placement = api.encode_placement(sl.pool, sl.topology, sl.slice_id,
                                         nodes, _iso(now),
                                         elastic=elastic_grant)
        self.client.patch(
            jobs_api.JOBS_API_VERSION, kind, name,
            {"metadata": {"annotations": {
                api.ANN_PLACEMENT: placement,
                api.ANN_PREEMPTED_BY: None,  # cleared on re-admission
            }}},
            ns,
        )
        job = dict(entry.job)
        job["metadata"] = dict(job["metadata"])
        self._write_scheduling(job, {
            "state": api.STATE_ADMITTED,
            "pool": sl.pool, "slice": sl.slice_id,
            "nodes": nodes, "admittedAt": _iso(now),
            "granted": len(nodes) if entry.elastic else None,
            "requeueAfter": None, "preemptedBy": None,
        }, condition=(api.COND_QUEUED, "False", "Admitted",
                      f"placed on {sl.pool}/{sl.slice_id}"))
        M_ADMISSIONS.labels(sl.pool).inc()
        M_QUEUE_WAIT.labels(entry.queue).observe(
            max((now - entry.queued_at).total_seconds(), 0.0))
        log.info("admitted %s -> %s/%s %s", _key_str(entry.key),
                 sl.pool, sl.slice_id, nodes)

    def _floor(self, job: Mapping) -> int:
        """An elastic job's smallest legal grant: every pod seated and at
        least minReplicas hosts."""
        elastic = api.elastic_spec(job)
        if elastic is None:
            return _gang_hosts(job)
        return max(_gang_hosts(job), elastic["min"])

    def _try_shrink(self, entry: QueueEntry, placed, capacity, book,
                    knobs, now, resized: set[str]) -> bool:
        """Seat ``entry`` by shrinking elastic jobs toward their floors —
        a placement rewrite the victims absorb live (step-boundary
        reshard), no eviction, no lost step. Applies only when shrinking
        fully seats the entry on one slice; chooses the slice needing the
        fewest shrunk jobs. Declaring ``spec.elastic`` is consent to run
        anywhere inside the range whenever the cluster is contended, so
        (unlike eviction) no priority gap gates the reclaim — grant above
        the floor is borrowed capacity."""
        candidates = []
        for sl in capacity.slices:
            if entry.accelerator not in (None, sl.pool):
                continue
            if sl.size < entry.hosts:
                continue
            free = len(capacity.free_hosts(sl))
            shrinkable = []
            for job in placed:
                decided = api.placement(job)
                if not decided or decided.get("slice") != sl.slice_id:
                    continue
                if api.elastic_spec(job) is None:
                    continue
                reclaim = len(decided["nodes"]) - self._floor(job)
                if reclaim > 0:
                    shrinkable.append((job, reclaim))
            # Lowest priority loses width first; bigger reclaim breaks
            # ties (fewer jobs disturbed for the same freed capacity).
            shrinkable.sort(key=lambda jr: (api.job_priority(jr[0]),
                                            -jr[1]))
            chosen, freed = [], free
            for job, reclaim in shrinkable:
                if freed >= entry.hosts:
                    break
                take = min(reclaim, entry.hosts - freed)
                chosen.append((job, take))
                freed += take
            if freed >= entry.hosts and chosen:
                candidates.append((len(chosen), sl, chosen))
        if not candidates:
            return False
        _, sl, chosen = min(candidates,
                            key=lambda c: (c[0], c[1].slice_id))
        for job, take in chosen:
            self._shrink(job, take, capacity, now)
            resized.add(_key_str(_job_key(job)))
        self._admit(entry, [sl], capacity, book, now)
        return True

    def _shrink(self, job: dict, hosts: int, capacity, now) -> None:
        """Return the tail ``hosts`` of an elastic grant. Pods sit on the
        grant's PREFIX (operators/jobs.py maps pod i to nodes[i]), so a
        tail drop never unseats a process — the job's training loop sees
        the smaller grant at its next placement poll and reshards."""
        decided = api.placement(job)
        keep = decided["nodes"][:len(decided["nodes"]) - hosts]
        dropped = decided["nodes"][len(keep):]
        self._rewrite_grant(job, decided, keep, now)
        capacity.vacate(dropped)
        M_SHRINKS.inc()
        log.info("shrunk %s to %d host(s), released %s",
                 _key_str(_job_key(job)), len(keep), dropped)

    def _grow_pass(self, placed, capacity, knobs, now,
                   resized: set[str]) -> None:
        """Extend under-max elastic grants into hosts left free after the
        queue pass (idle → data-parallel width). A job resized this round
        never regrows in it, and ``growDelaySeconds`` keeps a quiet
        period after any resize (anti-thrash)."""
        for job in placed:
            key = _key_str(_job_key(job))
            if key in resized:
                continue
            elastic = api.elastic_spec(job)
            decided = api.placement(job)
            if elastic is None or decided is None:
                continue
            granted = len(decided["nodes"])
            if granted >= elastic["max"]:
                continue
            sched = job.get("status", {}).get("scheduling", {}) or {}
            if knobs["grow_delay"] > 0 and sched.get("resizedAt"):
                try:
                    since = (now - parse_time(
                        sched["resizedAt"])).total_seconds()
                    if since < knobs["grow_delay"]:
                        continue
                except ValueError:
                    pass
            sl = next((s for s in capacity.slices
                       if s.pool == decided.get("pool")
                       and s.slice_id == decided.get("slice")), None)
            if sl is None:
                continue
            extra = min(len(capacity.free_hosts(sl)),
                        elastic["max"] - granted)
            if extra <= 0:
                continue
            nodes = decided["nodes"] + capacity.reserve(sl, extra, key)
            self._rewrite_grant(job, decided, nodes, now)
            M_GROWS.inc()
            log.info("grew %s to %d host(s) on %s/%s", key, len(nodes),
                     sl.pool, sl.slice_id)

    def _rewrite_grant(self, job: dict, decided: Mapping,
                       nodes: list[str], now) -> None:
        """Publish a resized grant: the SAME all-or-nothing placement
        annotation with a new node set, granted count updated, state
        still Admitted. Also updates the in-memory job dict so later
        passes in this round see the new grant, not the snapshot's."""
        elastic = api.elastic_spec(job) or {}
        kind, ns, name = _job_key(job)
        placement = api.encode_placement(
            decided.get("pool", ""), decided.get("topology", ""),
            decided.get("slice", ""), nodes, _iso(now),
            elastic={"granted": len(nodes),
                     "min": elastic.get("min", 1),
                     "max": elastic.get("max", len(nodes))})
        self.client.patch(
            jobs_api.JOBS_API_VERSION, kind, name,
            {"metadata": {"annotations": {api.ANN_PLACEMENT: placement}}},
            ns,
        )
        job.setdefault("metadata", {}).setdefault(
            "annotations", {})[api.ANN_PLACEMENT] = placement
        self._write_scheduling(job, {
            "nodes": list(nodes), "granted": len(nodes),
            "resizedAt": _iso(now),
        })

    def _try_preempt(self, entry: QueueEntry, placed, capacity,
                     pods_by_job, knobs, now,
                     exclude: set[str] = frozenset()) -> bool:
        """Free one slice for ``entry`` by evicting strictly lower-priority
        gangs. Chooses the slice needing the fewest victims; victims are
        the lowest-priority, most-recently-admitted gangs there. Jobs in
        ``exclude`` (shrunk this round) are never also evicted — one
        round disturbs a victim at most once."""
        candidates = []
        for sl in capacity.slices:
            if entry.accelerator not in (None, sl.pool):
                continue
            if sl.size < entry.hosts:
                continue
            free = len(capacity.free_hosts(sl))
            victims = []
            for job in placed:
                decided = api.placement(job)
                if not decided or decided.get("slice") != sl.slice_id:
                    continue
                if _key_str(_job_key(job)) in exclude:
                    continue
                if not api.is_preemptible(job):
                    continue
                gap = knobs["min_priority_gap"]
                if api.job_priority(job) + gap >= entry.priority:
                    continue
                victims.append(job)
            # Lowest priority first; bigger gangs break ties (fewer
            # victims evicted for the same freed capacity).
            victims.sort(key=lambda j: (
                api.job_priority(j), -len(api.placement(j)["nodes"])))
            chosen, freed = [], free
            for victim in victims:
                if freed >= entry.hosts:
                    break
                chosen.append(victim)
                freed += len(api.placement(victim)["nodes"])
            if freed >= entry.hosts and chosen:
                candidates.append((len(chosen), sl, chosen))
        if not candidates:
            return False
        _, sl, chosen = min(candidates,
                            key=lambda c: (c[0], c[1].slice_id))
        for victim in chosen:
            self._preempt(victim, by=entry, knobs=knobs, now=now,
                          pods=pods_by_job.get(_job_key(victim), []))
        return True

    def _preempt(self, victim: dict, *, by: QueueEntry, knobs, now,
                 pods) -> None:
        kind, ns, name = _job_key(victim)
        preemptor = _key_str(by.key)
        log.info("preempting %s/%s for %s", kind, name, preemptor)
        # 1. Revoke the reservation and mark the victim, in one patch:
        # the placement annotation disappearing is what parks the job
        # controller's recreate path until re-admission.
        self.client.patch(
            jobs_api.JOBS_API_VERSION, kind, name,
            {"metadata": {"annotations": {
                api.ANN_PLACEMENT: None,
                api.ANN_PREEMPTED_BY: preemptor,
            }}},
            ns,
        )
        self._write_scheduling(victim, {
            "state": api.STATE_PREEMPTED,
            "preemptedBy": preemptor,
            "requeueAfter": _iso(
                now + datetime.timedelta(
                    seconds=knobs["requeue_backoff"])),
            "pool": None, "slice": None, "nodes": None,
        }, condition=(api.COND_QUEUED, "True", "Preempted",
                      f"preempted by higher-priority {preemptor}"))
        # 2. Mark each pod, then evict it (SIGTERM → grace → SIGKILL via
        # the kubelet). A transiently failed delivery is retried by the
        # next round's pending-preemption sweep.
        self._evict_pods(victim, pods, preemptor, knobs)
        M_PREEMPTIONS.labels("priority").inc()
        M_REQUEUES.labels("preempted").inc()

    def _evict_pods(self, victim: dict, pods, preemptor: str,
                    knobs) -> None:
        """Mark + evict a victim's pods. The preempted-by mark lands
        FIRST so the job controller's preemption accounting recognizes
        the eviction whatever the pod's final phase/reason looks like."""
        ns = victim["metadata"].get("namespace")
        for pod_name in pods:
            try:
                self.client.patch(
                    POD_API, "Pod", pod_name,
                    {"metadata": {"annotations": {
                        api.ANN_PREEMPTED_BY: preemptor}}},
                    ns)
                pod = self.client.get(POD_API, "Pod", pod_name, ns)
            except Exception:
                continue  # pod vanished (or a fault): retried next round
            try:
                self._evict(pod, knobs["grace_seconds"])
            except Exception:
                log.exception("evicting %s/%s failed", ns, pod_name)

    def _default_evict(self, pod: dict, grace_seconds: float) -> bool:
        """Apiserver-visible shape of a kubelet eviction: Failed phase,
        Preempted reason, DisruptionTarget condition."""
        name = pod["metadata"]["name"]
        ns = pod["metadata"].get("namespace")

        def _write(client: K8sClient):
            current = client.get_or_none(POD_API, "Pod", name, ns)
            if current is None:
                return None
            status = current.setdefault("status", {})
            status["phase"] = "Failed"
            status["reason"] = "Preempted"
            conds = [c for c in status.get("conditions", [])
                     if c.get("type") != "DisruptionTarget"]
            conds.append({"type": "DisruptionTarget", "status": "True",
                          "reason": "PreemptionByScheduler"})
            status["conditions"] = conds
            return client.update_status(current)

        return retry_on_conflict(self.client, _write) is not None

    def _revoke(self, job: dict, *, reason: str, now, backoff) -> None:
        kind, ns, name = _job_key(job)
        self.client.patch(
            jobs_api.JOBS_API_VERSION, kind, name,
            {"metadata": {"annotations": {api.ANN_PLACEMENT: None}}},
            ns,
        )
        self._write_scheduling(job, {
            "state": api.STATE_QUEUED,
            "requeueAfter": _iso(
                now + datetime.timedelta(seconds=backoff)),
            "pool": None, "slice": None, "nodes": None,
        }, condition=(api.COND_QUEUED, "True", "Requeued",
                      f"placement revoked: {reason}"))

    def _mark_unschedulable(self, entry: QueueEntry,
                            capacity: ClusterCapacity) -> None:
        biggest = capacity.largest_slice(entry.accelerator)
        cond = (api.COND_UNSCHEDULABLE, "True", "NoFittingPool",
                f"gang needs {entry.hosts} host(s) on one "
                f"{entry.accelerator or 'any'} slice; largest is {biggest}")
        sched = entry.job.get("status", {}).get("scheduling", {}) or {}
        if sched.get("state") == api.STATE_UNSCHEDULABLE:
            return  # already surfaced; don't churn status writes
        self._write_scheduling(entry.job, {
            "state": api.STATE_UNSCHEDULABLE,
        }, condition=cond)

    # ------------------------------------------------------------------
    # status plumbing
    # ------------------------------------------------------------------

    def _write_scheduling(self, job: dict, fields: Mapping,
                          condition: tuple[str, str, str, str]
                          | None = None) -> None:
        """Merge scheduler-owned fields into the job's status (refetch +
        reapply on conflict). Touches ONLY status.scheduling and the
        scheduler's own condition types — the job controller keeps
        ownership of state/replicaStatuses/its conditions."""
        kind, ns, name = _job_key(job)

        def _write(client: K8sClient):
            current = client.get_or_none(jobs_api.JOBS_API_VERSION, kind,
                                         name, ns)
            if current is None:
                return None
            status = current.setdefault("status", {})
            sched = dict(status.get("scheduling", {}) or {})
            before = (dict(sched),
                      [c for c in status.get("conditions", [])
                       if c.get("type") in (api.COND_QUEUED,
                                            api.COND_UNSCHEDULABLE)])
            for k, v in fields.items():
                if v is None:
                    sched.pop(k, None)
                else:
                    sched[k] = v
            status["scheduling"] = sched
            if condition is not None:
                ctype, cstatus, reason, message = condition
                conds = status.setdefault("conditions", [])
                existing = next(
                    (c for c in conds if c.get("type") == ctype), None)
                new = {"type": ctype, "status": cstatus, "reason": reason,
                       "message": message,
                       "lastTransitionTime": _iso(_now_dt())}
                if existing is None:
                    conds.append(new)
                elif (existing.get("status") != cstatus
                      or existing.get("reason") != reason):
                    conds[conds.index(existing)] = new
                # Queued and Unschedulable are mutually exclusive.
                other = (api.COND_UNSCHEDULABLE if ctype == api.COND_QUEUED
                         else api.COND_QUEUED)
                for c in conds:
                    if c.get("type") == other and c.get("status") == "True":
                        c["status"] = "False"
            after = (status.get("scheduling"),
                     [c for c in status.get("conditions", [])
                      if c.get("type") in (api.COND_QUEUED,
                                           api.COND_UNSCHEDULABLE)])
            if before == after:
                return current  # no-op: don't emit MODIFIED storms
            return client.update_status(current)

        try:
            retry_on_conflict(self.client, _write)
        except Exception:
            # Transient apiserver faults on a status mirror must not kill
            # the round: the next round reconverges (level-triggered).
            log.debug("scheduling status write failed for %s/%s",
                      kind, name, exc_info=True)

    def _push_policy_status(self, policy: dict, depth: Mapping[str, int],
                            now) -> None:
        # Content-stable: no per-round timestamp, so a quiescent cluster
        # writes nothing (_push_status no-ops on equal status) and the
        # policy's own MODIFIED events can't self-trigger rounds forever.
        status = dict(policy.get("status", {}) or {})
        status["queueDepth"] = sum(depth.values())
        status["queueDepthByQueue"] = dict(sorted(depth.items()))
        updated = dict(policy)
        updated["status"] = status
        try:
            self._push_status(updated)
        except Exception:
            log.debug("policy status write failed", exc_info=True)
