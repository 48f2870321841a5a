"""Training loop; counterpart of ``kubeflow_tpu/train/loop.py``.

    python -m kubeflow_tpu_torch.train.loop '<json run config>'

trains one model of any family (the transformer LM, BERT, ResNet) on
synthetic batches of its family, with the JAX loop's step-time histogram,
throughput and input-stall accounting, prints its ``kubeflow-tpu-metrics:``
log line and returns (and prints) the same result keys as the JAX loop.

It runs as one process of a gang, one process per GPU: with the JaxJob
controller's environment (``JAX_COORDINATOR_ADDRESS``,
``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``) each process joins the process
group (``parallel.distributed.initialize_from_env``; NCCL on
``cuda:{process_id % GPUs}``, gloo with ``"device": "cpu"``), builds the
mesh of ``"mesh"`` (any of the six axes; their product is the number of
processes, -1 absorbs the rest) and trains its shard of the state on its
own rows: ``batch_size`` rows a process, as in JAX, the synthetic stream
the same on every process and the token store's shard of the process's
place on the batch axes (the ranks of an expert, tensor, pipeline or
sequence group read the same rows; under ``context_parallel`` a sequence
rank keeps its chunk of their tokens). Only process 0 logs. Without that
environment one process trains on ``"device"`` (default ``"cuda"``; pass
``"cpu"`` to run the plain PyTorch paths on the host), over a mesh only
if a process group is already running.

As the JAX loop does, it saves checkpoints (``checkpoint_dir``, every
``checkpoint_every`` steps, asynchronously with ``checkpoint_async``, and
once more at the end) and resumes from the latest one with the data stream
re-anchored at that step; on SIGTERM it stops after the step in flight and
saves that step synchronously (in a gang the stop is agreed every step,
``global_any``, so every process saves the same step). ``data_path``
reads a token file (``train/tokenstore.py``) instead of synthetic tokens,
for the transformer family only, as in JAX; ``profile_dir`` writes a
``torch.profiler`` Chrome trace of ``profile_steps`` steps from
``profile_start_step`` (counted from the first step this run takes), on
process 0.

Elastic resharding (``elastic_poll_steps``, or a ``mesh_source`` a caller
injects): the loop polls the scheduler's grant (``train/elastic.py``),
agrees on it over the gang and, on a new feasible target, drains the
prefetcher, saves the reshard step (with ``checkpoint_dir``), moves the
live state onto a mesh of the gang's first ``target`` ranks bit for bit
(``parallel/reshard.py``; the data axis absorbs the resize), rebuilds the
step and re-anchors the stream at that step. The ranks outside the mesh
stay in the loop: they join every agreement (the SIGTERM stop each step,
the target each poll) and every save's barrier, hold no shard, launch
nothing, and return the same result. With the job's environment
(``KUBEFLOW_TPU_JOB_NAME``) process 0 publishes the final metrics into
the job's ``status.metrics`` (``k8s_client.py``). Every family trains
over every axis; a mesh whose degrees do not divide the model's shapes
is refused before any step.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import sys
import time
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from kubeflow_tpu_torch import apis
from kubeflow_tpu_torch.models.registry import get_model
from kubeflow_tpu_torch.observability.metrics import Histogram
from kubeflow_tpu_torch.parallel.distributed import (
    broadcast_object,
    global_any,
    initialize_from_env,
    local_device,
    shutdown,
    world_size,
)
from kubeflow_tpu_torch.parallel.mesh import (
    AXIS_SEQUENCE,
    BATCH_AXES,
    MESH_AXES,
    MeshConfig,
    axis_index,
    axis_size,
    build_mesh,
    is_member,
)
from kubeflow_tpu_torch.train import elastic as elastic_lib
from kubeflow_tpu_torch.train.checkpoint import Checkpointer
from kubeflow_tpu_torch.train.data import (
    local_tokens,
    place_batch,
    stack_microbatches,
    synthetic_stream,
)
from kubeflow_tpu_torch.train.optimizers import OptimizerConfig
from kubeflow_tpu_torch.train.prefetch import Prefetcher
from kubeflow_tpu_torch.train.tokenstore import TokenStore
from kubeflow_tpu_torch.train.trainer import (
    build_train_step,
    init_state,
)


@dataclass
class RunConfig:
    model: str = "lm-test-tiny"
    model_overrides: dict = field(default_factory=dict)
    # Degrees of the JAX MeshConfig axes.
    mesh: dict = field(default_factory=dict)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    batch_size: int = 8
    seq_len: int = 128
    steps: int = 100
    log_every: int = 10
    # A producer thread synthesizes and copies batch N+k while step N runs;
    # the queue depth (0 = synchronous). Batch order is identical.
    prefetch: int = 2
    # Gradient accumulation over this many microbatches of batch_size.
    accum_steps: int = 1
    # Poll the scheduler's placement grant every this many steps and
    # reshard onto a changed one (train/elastic.py); 0 = a fixed mesh.
    elastic_poll_steps: int = 0
    # KTPU token-corpus file (train.tokenstore); empty = synthetic data.
    data_path: str | None = None
    checkpoint_dir: str | None = None
    checkpoint_every: int = 500
    # Commit periodic saves on a writer thread; the preemption and final
    # saves always wait.
    checkpoint_async: bool = True
    # Catch SIGTERM and save a final checkpoint at the step in flight.
    graceful_shutdown: bool = True
    seed: int = 0
    # torch.profiler trace of profile_steps steps from profile_start_step.
    profile_dir: str | None = None
    profile_start_step: int = 3
    profile_steps: int = 5
    device: str = "cuda"


def _first_mesh(info, device, mesh_cfg, mesh_source, log):
    """The run's first mesh: over every rank of the gang (None for one
    process), or with an elastic source over the first ranks its agreed
    grant names (a grant that cannot map is logged and ignored)."""
    world = world_size()
    num_slices = info.num_slices if info.is_multislice else None
    if mesh_source is not None:
        target = elastic_lib.agreed_target(mesh_source(), world)
        n = min(target or world, world)
        try:
            first = elastic_lib.scaled_mesh_config(mesh_cfg, n)
            if not dist.is_initialized():
                first.resolve(1)
                return None
            return build_mesh(first, device_type=device.type,
                              ranks=range(n))
        except ValueError as e:
            log(f"ignoring initial elastic grant of {n} device(s): {e}")
    if not dist.is_initialized():
        mesh_cfg.resolve(1)  # one device: every degree must be 1
        return None
    return build_mesh(mesh_cfg, device_type=device.type,
                      num_slices=num_slices)


def run(cfg: RunConfig, *, log=print, environ=None,
        mesh_source=None) -> dict:
    """Train; returns the final metrics {step, loss, samples_per_sec, ...}
    with the JAX loop's keys. ``environ`` (default ``os.environ``) holds
    the gang's and the job's variables.

    ``mesh_source`` (tests and the card's check inject it;
    ``elastic_poll_steps`` builds the placement poller for
    operator-launched pods) is a zero-argument callable returning the
    current target device count, or None for "no signal": the loop
    reshards at the next poll when the gang-agreed target differs from
    the running mesh."""
    env = os.environ if environ is None else environ
    unknown = set(cfg.mesh) - set(MESH_AXES) - {"ici_axes"}
    if unknown:
        raise ValueError(f"unknown mesh axes {sorted(unknown)}")
    model = get_model(cfg.model, **cfg.model_overrides)
    if cfg.data_path and model.family != "transformer":
        raise ValueError(f"data_path holds language-model tokens; the "
                         f"{model.family} family trains on synthetic "
                         "batches")
    info = initialize_from_env(env, device=cfg.device)
    device = local_device(info, cfg.device)
    if info.process_id != 0:
        log = _silent
    if mesh_source is None and cfg.elastic_poll_steps > 0:
        mesh_source = elastic_lib.placement_device_source(environ=env)
    if mesh_source is not None and info.is_multislice:
        log("elastic resharding is single-slice only; ignoring the "
            "placement poller on this multislice gang")
        mesh_source = None
    mesh_cfg = MeshConfig(**cfg.mesh)
    mesh = _first_mesh(info, device, mesh_cfg, mesh_source, log)
    ckpt = None
    if cfg.checkpoint_dir:
        ckpt = Checkpointer(cfg.checkpoint_dir, cfg.optimizer,
                            async_saves=cfg.checkpoint_async)

    # Kubernetes evictions deliver SIGTERM with a grace period: finish the
    # step in flight and save it. (Only the main thread may register; the
    # previous handler comes back when the run ends.)
    stop_requested = []
    prev_handler = None
    if cfg.graceful_shutdown:
        try:
            prev_handler = signal.getsignal(signal.SIGTERM)
            signal.signal(signal.SIGTERM,
                          lambda _s, _f: stop_requested.append(True))
        except ValueError:
            prev_handler = None  # not the main thread
    try:
        return _train(cfg, info, model, device, mesh, mesh_cfg, ckpt,
                      stop_requested, log, env, mesh_source)
    finally:
        if prev_handler is not None:
            signal.signal(signal.SIGTERM, prev_handler)


def _silent(*_args) -> None:
    pass


def _initial_state(cfg, model, device, mesh, ckpt, log):
    """(state, start step): this rank's shards of the seeded init, or of
    the newest checkpoint; a rank outside the mesh holds none (None) and
    reads only the step."""
    state = None
    if is_member(mesh):
        generator = torch.Generator(device=device).manual_seed(cfg.seed)
        state = init_state(generator, model, cfg.optimizer, mesh,
                           device=device)
    if ckpt is not None:
        restored = ckpt.restore_latest(state)
        if restored is not None:
            log(f"resumed from checkpoint step {restored[1]}")
            return restored
    return state, 0


def _make_batches(cfg, info, model, device, mesh, stream_step, store):
    """(batches, prefetcher) from the stream position ``stream_step``
    (microbatches): both streams are stateless in (seed, step), so a
    resumed run sees what an uninterrupted one would have. Each process
    makes its own rows: the token store's shard of the process, the
    synthetic stream the same everywhere (as in JAX)."""
    if store is not None:
        shard, shards = ((info.process_id, info.num_processes)
                         if mesh is None else
                         (axis_index(mesh, BATCH_AXES),
                          axis_size(mesh, BATCH_AXES)))
        stream = store.stream(cfg.batch_size, cfg.seq_len, seed=cfg.seed,
                              start_step=stream_step, shard=shard,
                              num_shards=shards)
        if getattr(model.config, "context_parallel", False):
            # The shifted pair, whose length the sequence degree divides
            # (as the synthetic batches and the JAX loop ship it).
            stream = ({"inputs": b["tokens"][:, :-1],
                       "targets": b["tokens"][:, 1:]} for b in stream)
    else:
        stream = synthetic_stream(model, cfg.batch_size, cfg.seq_len,
                                  seed=cfg.seed, start_step=stream_step)
    if cfg.accum_steps > 1:
        stream = stack_microbatches(stream, cfg.accum_steps)

    chunks = (mesh is not None
              and getattr(model.config, "context_parallel", False))

    def place(b):
        if chunks:
            b = local_tokens(b, axis_index(mesh, AXIS_SEQUENCE),
                             axis_size(mesh, AXIS_SEQUENCE),
                             microbatched=cfg.accum_steps > 1)
        return place_batch(b, device)

    if cfg.prefetch > 0:
        prefetcher = Prefetcher(stream, place, depth=cfg.prefetch)
        return prefetcher, prefetcher
    return (place(b) for b in stream), None


def _start_trace(device):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    return prof


def _stop_trace(prof, cfg, device, log) -> None:
    """Stop ``prof`` once the device has finished the traced steps and
    write its Chrome trace into ``cfg.profile_dir`` (a name TensorBoard's
    PyTorch profiler plugin lists)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prof.stop()
    os.makedirs(cfg.profile_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(
        cfg.profile_dir, f"{socket.gethostname()}_{os.getpid()}."
                         f"{time.time_ns()}.pt.trace.json"))
    log(f"profiler trace written to {cfg.profile_dir}")


def _devices(mesh) -> int:
    return 1 if mesh is None else mesh.mesh.numel()


def _reshard_point(cfg, info, model, device, mesh, mesh_cfg, state, step,
                   target, ckpt, prefetcher, store, log):
    """Move the run onto ``target`` ranks at ``step`` (every rank of the
    gang calls it): drain the prefetcher (its lookahead was placed for the
    old mesh), save the reshard step with a checkpointer (the old mesh's
    members gather it), move the state, rebuild the step and re-anchor the
    stream. Returns the new (mesh, state, step_fn, batches, prefetcher)
    and the event."""
    t_rs = time.perf_counter()
    if prefetcher is not None:
        prefetcher.close()
    if ckpt is not None:
        # Crash safety across the move, and the restore-into-target run
        # the bit-for-bit contract compares with.
        ckpt.save(step, state, force=True)
        ckpt.wait()
    mesh, state, step_fn, stats = elastic_lib.reshard_train_state(
        state, model, cfg.optimizer, mesh_cfg, target,
        accum_steps=cfg.accum_steps, mesh=mesh)
    batches, prefetcher = (_make_batches(
        cfg, info, model, device, mesh, step * cfg.accum_steps, store)
        if is_member(mesh) else (None, None))
    event = stats.to_dict()
    event["step"] = step
    event["downtime_seconds"] = round(time.perf_counter() - t_rs, 6)
    log(f"resharded {stats.direction} {stats.from_devices}->"
        f"{stats.to_devices} devices at step {step} in "
        f"{stats.seconds * 1e3:.0f}ms ({stats.method})")
    return (mesh, state, step_fn, batches, prefetcher), event


def _train(cfg, info, model, device, mesh, mesh_cfg, ckpt, stop_requested,
           log, env, mesh_source=None):
    # The state lives in this frame alone, so a rank that leaves the mesh
    # frees it when the reshard hands it None.
    state, start_step = _initial_state(cfg, model, device, mesh, ckpt, log)
    member = is_member(mesh)
    step_fn = (build_train_step(model, cfg.optimizer, mesh,
                                accum_steps=cfg.accum_steps)
               if member else None)
    # The stream position counts MICROBATCHES: an accumulating run resumed
    # at optimizer step N replays from microbatch N x accum_steps.
    store = TokenStore(cfg.data_path) if cfg.data_path else None
    batches, prefetcher = (_make_batches(
        cfg, info, model, device, mesh, start_step * cfg.accum_steps, store)
        if member else (None, None))
    poll_steps = (cfg.elastic_poll_steps
                  or (1 if mesh_source is not None else 0))
    world = world_size()
    # SIGTERM reaches each pod at its own step, but the save is a
    # collective: in a gang the flag is agreed every step, so every
    # process stops (and saves) at the same step.
    gang = cfg.graceful_shutdown and world > 1

    metrics = {}
    t_start = time.perf_counter()
    t_last = t_start
    samples_per_step = cfg.batch_size * cfg.accum_steps
    samples_since = 0
    throughput = 0.0
    host_wait_total = 0.0
    host_wait_since = 0.0
    step_time_ema = None
    # The EMA hides stragglers; the histogram's p50/p99 expose them.
    step_hist = Histogram()
    steps_done = 0
    prof = None
    preempted_at = None
    reshards = []
    rejected_target = None
    try:
        for step in range(start_step, cfg.steps):
            if (mesh_source is not None and poll_steps
                    and (step - start_step) % poll_steps == 0):
                # The poll cadence is deterministic in step, so every
                # process enters the agreement the same number of times.
                target = elastic_lib.agreed_target(mesh_source(), world)
                if (target and target != _devices(mesh)
                        and target != rejected_target):
                    try:
                        elastic_lib.scaled_mesh_config(mesh_cfg, target)
                        if target > world:
                            raise ValueError(
                                f"only {world} device(s) in this gang")
                    except ValueError as e:
                        rejected_target = target
                        log(f"ignoring reshard target {target}: {e}")
                    else:
                        rejected_target = None
                        (mesh, state, step_fn, batches, prefetcher), event = \
                            _reshard_point(cfg, info, model, device, mesh,
                                           mesh_cfg, state, step, target,
                                           ckpt, prefetcher, store, log)
                        member = is_member(mesh)
                        reshards.append(event)
            t_step = time.perf_counter()
            if cfg.profile_dir and info.process_id == 0:
                if step - start_step == cfg.profile_start_step:
                    prof = _start_trace(device)
                elif (prof is not None and step - start_step
                      == cfg.profile_start_step + cfg.profile_steps):
                    _stop_trace(prof, cfg, device, log)
                    prof = None
            if member:
                # Host wait: time this step spent blocked on input.
                t_fetch = time.perf_counter()
                batch = next(batches)
                host_wait = time.perf_counter() - t_fetch
                host_wait_total += host_wait
                host_wait_since += host_wait
                state, metrics = step_fn(state, batch)
                steps_done += 1
                samples_since += samples_per_step
                step_time = time.perf_counter() - t_step
                step_hist.observe(step_time)
                step_time_ema = (step_time if step_time_ema is None
                                 else 0.9 * step_time_ema + 0.1 * step_time)
                if (step + 1) % cfg.log_every == 0 or step + 1 == cfg.steps:
                    loss = float(metrics["loss"])  # sync point
                    now = time.perf_counter()
                    window = now - t_last
                    throughput = samples_since / window
                    stall_pct = 100.0 * host_wait_since / max(window, 1e-9)
                    depth = (f" qdepth={prefetcher.qsize()}"
                             if prefetcher is not None else "")
                    t_last, samples_since, host_wait_since = now, 0, 0.0
                    aux = (f" router_aux_loss="
                           f"{float(metrics['router_aux_loss']):.6f}"
                           if "router_aux_loss" in metrics else "")
                    log(f"step={step + 1} loss={loss:.4f} "
                        f"grad_norm={float(metrics['grad_norm']):.4f}{aux} "
                        f"samples/sec={throughput:.1f} "
                        f"input_stall={stall_pct:.1f}%{depth}")
            stop_now = bool(stop_requested)
            if gang:
                stop_now = global_any(stop_now)
            if stop_now:
                # Eviction: save the step just done SYNCHRONOUSLY (the
                # grace window is for this), so resume continues from here.
                preempted_at = step + 1
                if ckpt is not None:
                    ckpt.save(preempted_at, state, force=True)
                    ckpt.wait()
                    log(f"preempted: checkpoint saved at step "
                        f"{preempted_at}")
                break
            if ckpt is not None and (step + 1) % cfg.checkpoint_every == 0:
                ckpt.save(step + 1, state)  # async: training continues
    finally:
        # The producer thread must never outlive the loop.
        if prefetcher is not None:
            prefetcher.close()
        if store is not None:
            store.close()
    total_time = time.perf_counter() - t_start
    if prof is not None:  # short runs: close the trace instead of dropping it
        _stop_trace(prof, cfg, device, log)
    if ckpt is not None:
        if preempted_at is None and ckpt.latest_step() != cfg.steps:
            ckpt.save(cfg.steps, state, force=True)
        ckpt.close()  # waits for pending commits

    loss = float(metrics["loss"]) if metrics else None
    if mesh_source is not None and world > 1:
        # A rank outside the mesh, or one that left it, reports the loss
        # of the mesh's last step, as every member does.
        loss = broadcast_object(loss)
    result = {
        "step": preempted_at if preempted_at is not None else cfg.steps,
        "loss": loss,
        "samples_per_sec": throughput,
        "process_id": info.process_id,
        "preempted": preempted_at is not None,
        "input_stall_pct": round(
            100.0 * host_wait_total / max(total_time, 1e-9), 2),
        "host_wait_ms_per_step": round(
            1e3 * host_wait_total / max(steps_done, 1), 3),
        "step_time_ema_ms": round(1e3 * (step_time_ema or 0.0), 3),
        "step_time_p50_ms": round(1e3 * step_hist.quantile(0.5), 3),
        "step_time_p99_ms": round(1e3 * step_hist.quantile(0.99), 3),
        "prefetch_depth": cfg.prefetch,
        "accum_steps": cfg.accum_steps,
        # One event a live move: direction, devices, the move's seconds
        # and the whole downtime (drain, save, move, stream re-anchor).
        "devices": _devices(mesh),
        "reshard_count": len(reshards),
        "reshards": reshards,
    }
    if info.process_id == 0 and preempted_at is None:
        publish_metrics(result, environ=env, log=log)
    return result


def publish_metrics(result: dict, *, client=None, environ=None,
                    log=print) -> None:
    """Publish the final metrics into the owning job's ``status.metrics``
    (the path the study and benchmark controllers read), after their log
    line for log-scraping collectors. Without the job's environment
    (``KUBEFLOW_TPU_JOB_NAME``) only the line; a failed publish is
    logged, never raised (it must not stop a job that trained). The
    apiserver is ``KUBEFLOW_TPU_APISERVER``'s where it is set, as for
    the placement poller, else the client's default."""
    env = os.environ if environ is None else environ
    metrics = {k: v for k, v in result.items()
               if isinstance(v, (int, float)) and v is not None}
    log(f"kubeflow-tpu-metrics: {json.dumps(metrics)}")
    name = env.get(apis.ENV_JOB_NAME)
    if not name:
        return
    ns = env.get(apis.ENV_JOB_NAMESPACE, "default")
    kind = env.get(apis.ENV_JOB_KIND, "JaxJob")
    try:
        if client is None:
            from kubeflow_tpu_torch.k8s_client import (
                ClusterConfig,
                HttpK8sClient,
            )

            host = env.get(elastic_lib.ENV_APISERVER)
            client = HttpK8sClient(ClusterConfig(host=host) if host
                                   else None)
        job = client.get(apis.JOBS_API_VERSION, kind, name, ns)
        job.setdefault("status", {})["metrics"] = metrics
        client.update_status(job)
    except Exception as e:  # publishing must never stop training
        log(f"metrics publish failed: {e}")


def main(argv=None) -> int:
    """`python -m kubeflow_tpu_torch.train.loop '<json run config>'`"""
    argv = sys.argv[1:] if argv is None else argv
    overrides = json.loads(argv[0]) if argv else {}
    opt_cfg = OptimizerConfig(**overrides.pop("optimizer", {}))
    # Path fields honor environment references ($KUBEFLOW_ARTIFACT_DIR
    # and the like), as the JAX loop's do.
    for key in ("checkpoint_dir", "data_path", "profile_dir"):
        if overrides.get(key):
            overrides[key] = os.path.expandvars(overrides[key])
    try:
        result = run(RunConfig(optimizer=opt_cfg, **overrides))
    finally:
        shutdown()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
