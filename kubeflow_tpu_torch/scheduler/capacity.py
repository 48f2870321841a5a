"""Cluster capacity model: heterogeneous GPU pools built from Nodes; a copy
of ``kubeflow_tpu/scheduler/capacity.py`` over GPU nodes.

Nodes labelled with GKE's GPU accelerator type
(``cloud.google.com/gke-accelerator``, e.g. ``nvidia-h100-80gb``) form
*pools*; within a pool, nodes sharing a slice label form one *slice*,
the unit a gang must land wholly inside, and a node without a slice
label is a slice of its own. A host's GPUs are its
``status.capacity["nvidia.com/gpu"]``. Hosts are the placement grain: one
gang pod occupies one host, as in JAX.

Occupancy is derived, never stored: a host is busy iff a live placement
annotation (or a still-running pod of a revoked placement) claims it, so
the model is rebuilt from the apiserver every round.

The throughput book starts empty: JAX's built-in profiles are TPU
measurements, so here only a SchedulingPolicy's ``spec.profiles`` gives
numbers, and a pool the book does not know scores as JAX scores an
unknown one (a neutral 1.0). JAX's ``from_bench_files`` is not copied:
it reads TPU benchmark records, and the port has no benchmark yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, Mapping

from kubeflow_tpu_torch.apis import scheduling as api
from kubeflow_tpu_torch.manifests.images import GPU_RESOURCE


@dataclass
class Slice:
    """One slice: an ordered set of schedulable hosts."""

    pool: str            # accelerator type, e.g. "nvidia-h100-80gb"
    slice_id: str
    topology: str = ""   # GPU nodes carry no topology label
    nodes: list[str] = field(default_factory=list)
    chips_per_host: int = 0  # GPUs a host

    @property
    def size(self) -> int:
        return len(self.nodes)


class ClusterCapacity:
    """Pools/slices from Node objects + a within-round reservation view.

    ``reserve``/``occupy`` mutate only this in-memory view: one scheduling
    round works against one consistent snapshot, so two gangs admitted in
    the same round can never be handed overlapping hosts.
    """

    def __init__(self, slices: Iterable[Slice]):
        self.slices: list[Slice] = list(slices)
        self._busy: dict[str, str] = {}  # node name -> holder key

    @classmethod
    def from_nodes(cls, nodes: Iterable[Mapping]) -> "ClusterCapacity":
        by_slice: dict[tuple[str, str], Slice] = {}
        for node in nodes:
            meta = node.get("metadata", {})
            labels = meta.get("labels", {}) or {}
            accel = labels.get(api.NODE_ACCEL_LABEL)
            if not accel:
                continue  # not a GPU host
            if node.get("spec", {}).get("unschedulable"):
                continue  # cordoned / draining
            if _not_ready(node):
                continue  # a dead kubelet is not capacity
            slice_id = labels.get(api.NODE_SLICE_LABEL,
                                  f"{accel}-{meta.get('name', '')}")
            key = (accel, slice_id)
            sl = by_slice.get(key)
            if sl is None:
                sl = by_slice[key] = Slice(pool=accel, slice_id=slice_id)
            sl.nodes.append(meta.get("name", ""))
            gpus = (node.get("status", {}).get("capacity", {})
                    or {}).get(GPU_RESOURCE, 0)
            try:
                sl.chips_per_host = max(sl.chips_per_host, int(gpus))
            except (TypeError, ValueError):
                pass
        for sl in by_slice.values():
            sl.nodes.sort()  # deterministic host order
        return cls(sorted(by_slice.values(),
                          key=lambda s: (s.pool, s.slice_id)))

    @property
    def node_names(self) -> set[str]:
        return {n for sl in self.slices for n in sl.nodes}

    def pools(self) -> dict[str, list[Slice]]:
        out: dict[str, list[Slice]] = {}
        for sl in self.slices:
            out.setdefault(sl.pool, []).append(sl)
        return out

    def largest_slice(self, accelerator: str | None = None) -> int:
        sizes = [sl.size for sl in self.slices
                 if accelerator in (None, sl.pool)]
        return max(sizes, default=0)

    def free_hosts(self, sl: Slice) -> list[str]:
        return [n for n in sl.nodes if n not in self._busy]

    def holder(self, node: str) -> str | None:
        return self._busy.get(node)

    def occupy(self, nodes: Iterable[str], holder: str) -> None:
        """Mark hosts busy (existing placements / still-running pods).
        First holder wins: a stale pod of a revoked placement keeps the
        host busy until it exits."""
        for node in nodes:
            self._busy.setdefault(node, holder)

    def release(self, holder: str) -> None:
        self._busy = {n: h for n, h in self._busy.items() if h != holder}

    def vacate(self, nodes: Iterable[str]) -> None:
        """Free specific hosts (an elastic shrink returns the tail of a
        grant while the holder keeps the rest)."""
        for node in nodes:
            self._busy.pop(node, None)

    def feasible(self, n_hosts: int,
                 accelerator: str | None = None) -> list[Slice]:
        """Slices with >= n_hosts free right now (accelerator-filtered)."""
        return [sl for sl in self.slices
                if accelerator in (None, sl.pool)
                and len(self.free_hosts(sl)) >= n_hosts]

    def ever_fits(self, n_hosts: int,
                  accelerator: str | None = None) -> bool:
        """Could the request fit an EMPTY cluster? False means the job is
        structurally unschedulable, not merely waiting for capacity."""
        return n_hosts <= self.largest_slice(accelerator)

    def reserve(self, sl: Slice, n_hosts: int, holder: str) -> list[str]:
        """Claim n_hosts on one slice, all or nothing."""
        free = self.free_hosts(sl)
        if len(free) < n_hosts:
            raise ValueError(
                f"slice {sl.slice_id}: {len(free)} free < {n_hosts}")
        nodes = free[:n_hosts]
        for node in nodes:
            self._busy[node] = holder
        return nodes


def _not_ready(node: Mapping) -> bool:
    for cond in node.get("status", {}).get("conditions", []) or []:
        if cond.get("type") == "Ready":
            return cond.get("status") != "True"
    return False  # no conditions reported: schedulable (fake nodes)


class ThroughputBook:
    """(profile, accelerator) -> measured throughput, from a policy's
    ``spec.profiles``. Scores placements Gavel-style: normalized
    throughput, so a job runs where it is *measured* fastest. A profile
    the book lacks reads the ``default`` table; an accelerator a table
    lacks reads 1.0 (placeable, not favored)."""

    def __init__(self, profiles: Mapping[str, Mapping[str, float]]
                 | None = None):
        merged: dict[str, dict[str, float]] = {"default": {}}
        for name, table in (profiles or {}).items():
            if isinstance(table, Mapping):
                merged.setdefault(name, {}).update(
                    {a: float(t) for a, t in table.items()})
        self._profiles = merged

    def throughput(self, profile: str | None, accelerator: str) -> float:
        table = self._profiles.get(profile or "default") \
            or self._profiles["default"]
        if accelerator in table:
            return float(table[accelerator])
        return 1.0

    def score(self, profile: str | None, accelerator: str) -> float:
        """Normalized throughput: 1.0 on the job's best pool."""
        table = self._profiles.get(profile or "default") \
            or self._profiles["default"]
        best = max(table.values(), default=1.0)
        return self.throughput(profile, accelerator) / max(best, 1e-9)
