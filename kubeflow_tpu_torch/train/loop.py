"""Training loop; counterpart of ``kubeflow_tpu/train/loop.py``.

    python -m kubeflow_tpu_torch.train.loop '<json run config>'

trains one model on one device (``"device"``, default ``"cuda"``; pass
``"cpu"`` to run the plain PyTorch paths on the host) with the JAX loop's
step-time histogram, throughput and input-stall accounting, prints its
``kubeflow-tpu-metrics:`` log line and returns (and prints) the same result
keys as the JAX loop.

Not yet ported, and refused at the start of :func:`run` before any step:
checkpoints (``checkpoint_dir``), a token store (``data_path``), elastic
resharding (``elastic_poll_steps``), profiling (``profile_dir``), a mesh
of more than one device, and the job-status publish that the job's
environment (``KUBEFLOW_TPU_JOB_NAME``) asks for.
"""

from __future__ import annotations

import json
import os
import signal
import sys
import time
from dataclasses import dataclass, field

import torch

from kubeflow_tpu_torch.device import resolve_device
from kubeflow_tpu_torch.models.registry import get_model
from kubeflow_tpu_torch.observability.metrics import Histogram
from kubeflow_tpu_torch.train.data import (
    place_batch,
    stack_microbatches,
    synthetic_stream,
)
from kubeflow_tpu_torch.train.optimizers import OptimizerConfig
from kubeflow_tpu_torch.train.prefetch import Prefetcher
from kubeflow_tpu_torch.train.trainer import build_train_step, init_state

# The job-status environment of kubeflow_tpu/apis/jobs.py (copied name).
ENV_JOB_NAME = "KUBEFLOW_TPU_JOB_NAME"


@dataclass
class RunConfig:
    model: str = "lm-test-tiny"
    model_overrides: dict = field(default_factory=dict)
    # Degrees of the JAX MeshConfig axes; only one device (every degree 1,
    # or -1 for "the rest", which is 1 here) is ported.
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
    elastic_poll_steps: int = 0
    data_path: str | None = None
    checkpoint_dir: str | None = None
    # Catch SIGTERM and stop after the step in flight.
    graceful_shutdown: bool = True
    seed: int = 0
    profile_dir: str | None = None
    device: str = "cuda"


def _refuse_unported(cfg: RunConfig, environ) -> None:
    def no(what):
        raise ValueError(f"{what} is not yet ported to the PyTorch package")

    if cfg.checkpoint_dir:
        no("checkpointing (checkpoint_dir)")
    if cfg.data_path:
        no("the token store (data_path)")
    if cfg.elastic_poll_steps:
        no("elastic resharding (elastic_poll_steps)")
    if cfg.profile_dir:
        no("profiling (profile_dir)")
    if any(n not in (1, -1) for n in cfg.mesh.values()):
        no(f"a multi-device mesh ({cfg.mesh})")
    if environ.get(ENV_JOB_NAME):
        no(f"publishing metrics into the job status ({ENV_JOB_NAME} is "
           "set)")


def run(cfg: RunConfig, *, log=print, environ=None) -> dict:
    """Train; returns the final metrics {step, loss, samples_per_sec, ...}
    with the JAX loop's keys."""
    _refuse_unported(cfg, os.environ if environ is None else environ)
    device = resolve_device(cfg.device)
    model = get_model(cfg.model, **cfg.model_overrides)
    generator = torch.Generator(device=device).manual_seed(cfg.seed)
    state = init_state(generator, model, cfg.optimizer, device=device)

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
        return _train(cfg, model, device, state, stop_requested, log)
    finally:
        if prev_handler is not None:
            signal.signal(signal.SIGTERM, prev_handler)


def _make_batches(cfg, model, device):
    stream = synthetic_stream(model, cfg.batch_size, cfg.seq_len,
                              seed=cfg.seed)
    if cfg.accum_steps > 1:
        stream = stack_microbatches(stream, cfg.accum_steps)

    def place(b):
        return place_batch(b, device)

    if cfg.prefetch > 0:
        prefetcher = Prefetcher(stream, place, depth=cfg.prefetch)
        return prefetcher, prefetcher
    return (place(b) for b in stream), None


def _train(cfg, model, device, state, stop_requested, log):
    step_fn = build_train_step(model, cfg.optimizer,
                               accum_steps=cfg.accum_steps)
    batches, prefetcher = _make_batches(cfg, model, device)

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
    preempted_at = None
    try:
        for step in range(cfg.steps):
            t_step = time.perf_counter()
            # Host wait: time this step spent blocked on input.
            batch = next(batches)
            host_wait = time.perf_counter() - t_step
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
                log(f"step={step + 1} loss={loss:.4f} "
                    f"grad_norm={float(metrics['grad_norm']):.4f} "
                    f"samples/sec={throughput:.1f} "
                    f"input_stall={stall_pct:.1f}%{depth}")
            if stop_requested:
                preempted_at = step + 1
                break
    finally:
        # The producer thread must never outlive the loop.
        if prefetcher is not None:
            prefetcher.close()
    total_time = time.perf_counter() - t_start

    result = {
        "step": preempted_at if preempted_at is not None else cfg.steps,
        "loss": float(metrics["loss"]) if metrics else None,
        "samples_per_sec": throughput,
        "process_id": 0,
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
        "devices": 1,
        "reshard_count": 0,
        "reshards": [],
    }
    if preempted_at is None:
        publish_metrics(result, log=log)
    return result


def publish_metrics(result: dict, *, log=print) -> None:
    """The log-line form of the final metrics, for log-scraping
    collectors (the job-status publish is not yet ported)."""
    metrics = {k: v for k, v in result.items()
               if isinstance(v, (int, float)) and v is not None}
    log(f"kubeflow-tpu-metrics: {json.dumps(metrics)}")


def main(argv=None) -> int:
    """`python -m kubeflow_tpu_torch.train.loop '<json run config>'`"""
    argv = sys.argv[1:] if argv is None else argv
    overrides = json.loads(argv[0]) if argv else {}
    opt_cfg = OptimizerConfig(**overrides.pop("optimizer", {}))
    for key in ("checkpoint_dir", "data_path", "profile_dir"):
        if overrides.get(key):
            overrides[key] = os.path.expandvars(overrides[key])
    result = run(RunConfig(optimizer=opt_cfg, **overrides))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
