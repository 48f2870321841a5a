"""Persisted workflow run history, as the central dashboard reads it; a
copy of ``kubeflow_tpu/operators/runstore.py`` over the port's client.

Every Workflow run leaves a record that outlives the Workflow CR: a
ConfigMap labeled for listing, not owner-referenced to the Workflow, so
deleting the CR keeps its history.
"""

from __future__ import annotations

import json

from kubeflow_tpu_torch.k8s_client import ApiError, K8sClient

RUN_LABEL = "kubeflow-tpu.org/workflow-run"
SCHEDULE_LABEL = "kubeflow-tpu.org/scheduled-workflow"


class RunStore:
    def __init__(self, client: K8sClient):
        self.client = client

    @staticmethod
    def _record_name(workflow_name: str) -> str:
        return f"wfrun-{workflow_name}"

    def record(self, wf: dict) -> None:
        """Create or update the run record mirroring the workflow's
        current status. Called by the WorkflowController on start and on
        every status change through terminal."""
        meta = wf["metadata"]
        status = wf.get("status", {})
        record = {
            "workflow": meta["name"],
            "namespace": meta["namespace"],
            "scheduledWorkflow": meta.get("labels", {}).get(
                SCHEDULE_LABEL, ""
            ),
            "phase": status.get("phase", "Pending"),
            "message": status.get("message", ""),
            "startedAt": status.get("startedAt", ""),
            "finishedAt": status.get("finishedAt", ""),
            "tasks": status.get("tasks", {}),
            # Flattened output-artifact index (the minio/KFP artifact
            # listing): URIs stay resolvable through the artifact store
            # after the Workflow CR is deleted.
            "artifacts": [
                art
                for ts in status.get("tasks", {}).values()
                for art in ts.get("artifacts", [])
            ],
        }
        cm = {
            "apiVersion": "v1",
            "kind": "ConfigMap",
            "metadata": {
                "name": self._record_name(meta["name"]),
                "namespace": meta["namespace"],
                "labels": {
                    RUN_LABEL: "true",
                    **({SCHEDULE_LABEL: record["scheduledWorkflow"]}
                       if record["scheduledWorkflow"] else {}),
                },
            },
            "data": {"record.json": json.dumps(record, sort_keys=True)},
        }
        try:
            self.client.create(cm)
        except ApiError as e:
            if e.code != 409:
                raise
            live = self.client.get("v1", "ConfigMap",
                                   cm["metadata"]["name"],
                                   meta["namespace"])
            live["data"] = cm["data"]
            live["metadata"].setdefault("labels", {}).update(
                cm["metadata"]["labels"]
            )
            self.client.update(live)

    def ensure_recorded(self, wf: dict) -> None:
        """Heal a lost/stale record for a (terminal) workflow: a transient
        apiserver error during the original record() must not permanently
        lose the run's final state."""
        meta = wf["metadata"]
        phase = wf.get("status", {}).get("phase", "")
        cm = self.client.get_or_none(
            "v1", "ConfigMap", self._record_name(meta["name"]),
            meta["namespace"],
        )
        if cm is not None:
            try:
                if json.loads(cm["data"]["record.json"])["phase"] == phase:
                    return
            except (KeyError, ValueError):
                pass
        self.record(wf)

    def list_runs(self, namespace: str | None = None,
                  schedule: str | None = None) -> list[dict]:
        """Run records, newest-started first."""
        selector = {RUN_LABEL: "true"}
        if schedule:
            selector[SCHEDULE_LABEL] = schedule
        runs = []
        for cm in self.client.list("v1", "ConfigMap", namespace,
                                   label_selector=selector):
            try:
                runs.append(json.loads(cm["data"]["record.json"]))
            except (KeyError, ValueError):
                continue
        runs.sort(key=lambda r: r.get("startedAt", ""), reverse=True)
        return runs

    def prune(self, namespace: str, schedule: str, keep: int) -> int:
        """Keep the newest ``keep`` records for a schedule; delete the
        rest. Returns how many were removed."""
        if keep <= 0:
            return 0
        runs = self.list_runs(namespace, schedule=schedule)
        return self._delete_records(namespace, runs[keep:])

    def prune_adhoc(self, namespace: str, keep: int) -> int:
        """Retention for runs with no owning schedule — ad-hoc Workflows
        (CI one-offs) must not leak one ConfigMap per run forever."""
        if keep <= 0:
            return 0
        adhoc = [r for r in self.list_runs(namespace)
                 if not r.get("scheduledWorkflow")]
        return self._delete_records(namespace, adhoc[keep:])

    def _delete_records(self, namespace: str, runs: list[dict]) -> int:
        removed = 0
        for run in runs:
            try:
                self.client.delete(
                    "v1", "ConfigMap",
                    self._record_name(run["workflow"]), namespace,
                )
                removed += 1
            except ApiError:
                pass
        return removed
