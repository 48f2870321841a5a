"""Elastic training: live resharding driven by the scheduler's grant;
counterpart of ``kubeflow_tpu/train/elastic.py``.

The scheduler resizes an elastic job by rewriting its placement
annotation (the grant inside ``spec.elastic.{minReplicas,maxReplicas}``);
the loop polls it between steps and, on a changed target, drains the input
pipeline, moves the live ``TrainState`` onto the new mesh
(:mod:`kubeflow_tpu_torch.parallel.reshard`, bit for bit), rebuilds the
step, re-anchors the data stream (stateless in ``(seed, step)``) and goes
on: no process restart, no lost step.

The port runs one process per GPU, so the gang's processes are its
devices: a mesh of ``n`` takes ranks ``0..n-1`` (JAX's
``jax.devices()[:n]``) and the other ranks stay in the loop outside it,
holding no shard, until a grow takes them back.

The contract, as in JAX: the resharded run is bit for bit the run that
stops at the reshard step and restores its checkpoint into the target
mesh (compute over another mesh degree is f32 equivalent, not bitwise, to
a fixed-mesh run).
"""

from __future__ import annotations

import os
import time
from typing import Callable

from kubeflow_tpu_torch import apis
from kubeflow_tpu_torch.observability.metrics import MetricRegistry
from kubeflow_tpu_torch.parallel.reshard import (
    ReshardStats,
    reshard_state,
    scaled_mesh_config,
)

# The reshard families, on the port's own registry (JAX puts them on the
# operators' shared registry): in-process runs read them here, a worker
# process reports the same numbers in the result's `reshards` timeline.
ELASTIC_METRICS = MetricRegistry()
M_RESHARDS = ELASTIC_METRICS.counter(
    "train_reshards_total",
    "Live train-state remaps between mesh shapes, by direction",
    labels=("direction",))
M_RESHARD_SECONDS = ELASTIC_METRICS.histogram(
    "train_reshard_seconds",
    "Wall time of one live reshard (drain to new jitted step ready)")

ENV_APISERVER = "KUBEFLOW_TPU_APISERVER"

# "No target seen here" in the gang's min: above any real device count,
# so the min only surfaces a target some process has seen.
_NO_TARGET = 2**31 - 1


def placement_device_source(*, environ=None, client=None,
                            total_devices: int | None = None
                            ) -> Callable[[], int | None] | None:
    """A poll callable mapping the job's live placement annotation to a
    target device count, or None when the process has no job identity
    (not operator-launched). Target devices = the gang's devices (its
    world size, 1 without a process group: one GPU a process) x
    granted / max. An apiserver fault reads as "no change": polling must
    never stop training."""
    from kubeflow_tpu_torch.parallel.distributed import world_size

    env = os.environ if environ is None else environ
    name = env.get(apis.ENV_JOB_NAME)
    if not name:
        return None
    ns = env.get(apis.ENV_JOB_NAMESPACE, "default")
    kind = env.get(apis.ENV_JOB_KIND, "JaxJob")
    if client is None:
        from kubeflow_tpu_torch.k8s_client import ClusterConfig, HttpK8sClient

        host = env.get(ENV_APISERVER)
        client = HttpK8sClient(ClusterConfig(host=host) if host else None)

    def poll() -> int | None:
        try:
            job = client.get(apis.JOBS_API_VERSION, kind, name, ns)
        except Exception:
            return None
        grant = apis.placement_grant(job)
        if grant is None:
            return None
        granted, cap = grant
        n = total_devices if total_devices else world_size()
        return max(1, (n * granted) // cap)

    return poll


def agreed_target(local: int | None, num_processes: int) -> int | None:
    """The gang's target: each process polls on its own and may see a
    rewrite at another step, so the observed targets are reduced to their
    min (absent = +inf) over the gang's host group, the same on every
    process (the earliest observer drives the gang; two racing rewrites
    resolve to the smaller grant until the next poll). A single process
    returns its own."""
    if num_processes <= 1:
        return local
    from kubeflow_tpu_torch.parallel.distributed import global_min_int

    agreed = global_min_int(local if local is not None else _NO_TARGET)
    return None if agreed >= _NO_TARGET else agreed


def reshard_train_state(state, model, opt_cfg, base_mesh_config,
                        target_devices: int, *, accum_steps: int = 1,
                        mesh=None):
    """Move a live TrainState onto ``target_devices`` ranks (the first ones
    of the gang) and rebuild the step for the new mesh; returns ``(mesh,
    state, step_fn, stats)``. Every rank of the gang calls it at the same
    point; ``mesh`` is the running mesh (default: the state's), and a
    rank outside it passes ``state`` None. A rank outside the new mesh
    gets state and step_fn None back. The data axis absorbs the resize
    (:func:`scaled_mesh_config`); the move itself is bit for bit. The
    replaced mesh's groups are freed."""
    from kubeflow_tpu_torch.parallel.distributed import (
        broadcast_object,
        world_size,
    )
    from kubeflow_tpu_torch.parallel.mesh import (
        build_mesh,
        destroy_mesh,
        mesh_ranks,
    )
    from kubeflow_tpu_torch.train.trainer import (
        StateLayout,
        build_train_step,
        token_axes,
    )

    world = world_size()
    if target_devices > world:
        raise ValueError(
            f"target {target_devices} devices but only {world} are in "
            "the gang")
    old = mesh if mesh is not None else state.layout.mesh
    t0 = time.perf_counter()
    new = build_mesh(scaled_mesh_config(base_mesh_config, target_devices),
                     device_type=old.device_type,
                     ranks=range(target_devices))
    rules = model.partition_rules(model.config)
    # Each parameter's whole shape, from the old mesh's first rank (a rank
    # outside the mesh holds no state to read them from).
    shapes = broadcast_object(None if state is None else state.layout.shapes,
                              src=mesh_ranks(old)[0])
    src = (state.layout if state is not None
           else StateLayout(old, rules, shapes, token_axes(model)))
    dst = StateLayout(new, rules, shapes, token_axes(model))
    result = reshard_state(state, src, dst)
    destroy_mesh(old)
    step_fn = (build_train_step(model, opt_cfg, new, accum_steps=accum_steps)
               if dst.member else None)
    stats: ReshardStats = result.stats
    stats.seconds = time.perf_counter() - t0
    M_RESHARDS.labels(stats.direction).inc()
    M_RESHARD_SECONDS.observe(stats.seconds)
    return new, result.tree, step_fn, stats
