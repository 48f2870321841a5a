"""Minimal RL learner loop, the entry point RLJob learner pods run.

Counterpart of ``kubeflow_tpu/train/rl.py``. The Podracer split over the
platform's two halves: ACTORS are a
:class:`~kubeflow_tpu_torch.serving.fleet.DecoderFleet` of continuous
decoders generating rollouts (or, across pods, a
:class:`~kubeflow_tpu_torch.serving.remote_fleet.RemoteActorFleet` of
model servers); the LEARNER consumes them through the
:class:`~kubeflow_tpu_torch.train.prefetch.Prefetcher` (actors generate
batch N+k while the learner steps on batch N) and pushes fresh weights
fleet-wide every K optimizer steps over the live weight push
(``broadcast_weights`` -> ``ContinuousDecoder.update_weights``): a swap
between dispatches, so actors never restart or drop a stream, and
rollouts after the push are on-policy for the new weights.

The learning signal is next-token likelihood on the fleet's own rollouts
with the prompt positions masked to -1 (the loss ignores negative
targets): the self-training case of policy gradient with unit reward.
The loop's value is the systems contract it drives end to end: rollout
generation, prefetched consumption, the periodic live push, bounded
version skew (``weights_max_lag``), and the restart-per-update baseline.

On one card the learner (float32 master weights, the optimizer's state,
flash attention forward and backward in its steps) and the actors (one
serving tree in ``cfg.dtype``, shared until the first push gives each its
own, and a block pool each) share the device; the Prefetcher's producer
thread decodes while the learner steps, both on the default stream.

``restart_per_update=True`` runs the baseline: every update STOPS the
actor fleet and rebuilds the decoders from scratch on the new weights.
Eager PyTorch keeps no compiled executables, so nothing stands in for
the JAX loop's ``jax.clear_caches`` there.
"""

from __future__ import annotations

import json
import os
import sys
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from kubeflow_tpu_torch.device import resolve_device
from kubeflow_tpu_torch.models.registry import get_model
from kubeflow_tpu_torch.train.data import place_batch
from kubeflow_tpu_torch.train.optimizers import OptimizerConfig
from kubeflow_tpu_torch.train.prefetch import Prefetcher
from kubeflow_tpu_torch.train.trainer import build_train_step, init_state
from kubeflow_tpu_torch.weights import _unflatten, flatten


@dataclass
class RLConfig:
    model: str = "lm-test-tiny"
    model_overrides: dict = field(default_factory=dict)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    steps: int = 8
    batch_size: int = 4
    # Push fresh weights into the actor fleet every K optimizer steps.
    push_every_steps: int = 2
    prompt_len: int = 8
    max_new_tokens: int = 16
    # Bounded weight staleness across the fleet: actors lagging the
    # latest push by more than this many epochs leave rollout routing
    # until a later push lands on them.
    weights_max_lag: int = 1
    # Rollout lookahead (Prefetcher depth): actors generate batch N+k
    # while the learner steps on batch N. 0 = synchronous.
    prefetch: int = 2
    # In-process actor pool shape (ignored when a fleet is injected).
    actors: int = 2
    actor_slots: int = 4
    kv_block_size: int = 8
    # The actors read their block pool through the paged decode kernel
    # (False: the gathered read, as the JAX loop's actors do; the kernel
    # takes head_dim 64 or 128 and block sizes a multiple of 8).
    kv_fused: bool = False
    seed: int = 0
    temperature: float = 0.0
    # The baseline: tear actors down and rebuild them on every update
    # instead of pushing live.
    restart_per_update: bool = False
    # "cuda" raises without a CUDA device; "cpu" runs the plain paths.
    device: str = "cuda"


def serving_params(params, spec, device=None) -> dict:
    """A serving tree from the learner's master weights: every leaf a new
    tensor (the optimizer updates the masters in place, so an actor must
    never alias them) in the dtype the decoder reads it in, on
    ``device`` (default: the masters')."""
    cfg = spec.config
    return _unflatten({
        p: t.detach().to(device or t.device, cfg.leaf_dtype(p), copy=True)
        for p, t in flatten(params).items()})


def _build_actor(params, cfg: RLConfig, spec, *, seed: int = 0):
    from kubeflow_tpu_torch.serving.continuous import ContinuousDecoder

    total = cfg.prompt_len + cfg.max_new_tokens
    block = cfg.kv_block_size
    if total % block:
        block = 1
    return ContinuousDecoder(
        params, spec.config, slots=cfg.actor_slots,
        prefill_len=cfg.prompt_len, max_new_tokens=cfg.max_new_tokens,
        kv_layout="paged", kv_block_size=block, kv_fused=cfg.kv_fused,
        prefix_cache_slots=cfg.actor_slots,
        prefix_cache_min_len=min(4, cfg.prompt_len),
        stream_timeout_s=600.0, seed=seed)


def build_actor_fleet(params, cfg: RLConfig, spec=None):
    """An in-process rollout fleet: ``cfg.actors`` continuous decoders
    behind prefix-affine routing with the version-skew bound armed.
    ``params`` (the learner's masters, or any tree of the model) is cast
    to one serving tree the actors share: an install swaps a replica's
    reference and never writes in place."""
    from kubeflow_tpu_torch.serving.fleet import DecoderFleet

    spec = spec or get_model(cfg.model, **cfg.model_overrides)
    tree = serving_params(params, spec)
    replicas = {f"actor{i}": _build_actor(tree, cfg, spec, seed=i)
                for i in range(max(1, cfg.actors))}
    return DecoderFleet(replicas, weights_max_lag=cfg.weights_max_lag)


def _prompt(cfg: RLConfig, i: int) -> list[int]:
    """Deterministic rollout prompts: a shared lead-in (the fleet's
    prefix tries concentrate it) plus a per-rollout tail."""
    vocab_span = 97
    shared = [3 + (j % 13) for j in range(max(1, cfg.prompt_len // 2))]
    tail = [5 + ((i * 7 + j) % vocab_span)
            for j in range(cfg.prompt_len - len(shared))]
    return (shared + tail)[: cfg.prompt_len]


def rollout_stream(fleet, cfg: RLConfig, counters: dict):
    """Infinite iterator of learner batches generated by the actor
    fleet. Each yielded batch is ``{"inputs": [B, T], "targets":
    [B, T]}`` (int32 numpy) with PROMPT positions masked to -1, so the
    learner trains only on tokens the policy itself emitted. Runs on the
    Prefetcher's producer thread; the fleet is thread-safe, and a dead
    replica just remaps (the fleet raises only when the whole pool is
    gone, which ends the run)."""
    width = cfg.prompt_len + cfg.max_new_tokens
    i = 0
    while True:
        seqs = np.full((cfg.batch_size, width), 0, np.int32)
        mask_to = np.zeros((cfg.batch_size,), np.int32)
        for b in range(cfg.batch_size):
            prompt = _prompt(cfg, i)
            i += 1
            out = fleet.generate(prompt, cfg.max_new_tokens,
                                 cfg.temperature, timeout=600)["tokens"]
            seq = (prompt + out)[:width]
            seqs[b, : len(seq)] = seq
            mask_to[b] = len(prompt) - 1  # target idx < this is prompt
            counters["rollout_tokens"] += len(out)
            counters["rollouts"] += 1
        inputs = seqs[:, :-1]
        targets = seqs[:, 1:].copy()
        for b in range(cfg.batch_size):
            targets[b, : mask_to[b]] = -1
        yield {"inputs": inputs, "targets": targets}


def _batches(stream, cfg: RLConfig, device):
    """(batch iterator, prefetcher or None): placed on ``device`` by the
    producer thread when prefetching."""
    if cfg.prefetch > 0:
        prefetcher = Prefetcher(stream,
                                lambda b: place_batch(b, device),
                                depth=cfg.prefetch)
        return prefetcher, prefetcher
    return (place_batch(b, device) for b in stream), None


def run_rl(cfg: RLConfig, *, fleet=None, log=print) -> dict:
    """Run the learner loop; returns final metrics. ``fleet`` injects
    an existing actor pool (tests, the card's check); None builds the
    in-process pool from ``cfg.actors``. The loop owns a fleet it built
    (stopped on exit) but never one it was handed."""
    spec = get_model(cfg.model, **cfg.model_overrides)
    device = resolve_device(cfg.device)
    generator = torch.Generator(device=device).manual_seed(cfg.seed)
    state = init_state(generator, spec, cfg.optimizer, device=device)
    step_fn = build_train_step(spec, cfg.optimizer)
    owns_fleet = fleet is None
    if fleet is None:
        fleet = build_actor_fleet(state.params, cfg, spec)
    counters = {"rollout_tokens": 0, "rollouts": 0}
    batches, prefetcher = _batches(rollout_stream(fleet, cfg, counters),
                                   cfg, device)
    pushes = 0
    push_seconds: list[float] = []
    restart_seconds: list[float] = []
    version = 0
    metrics = {}
    t0 = time.perf_counter()
    try:
        for step in range(cfg.steps):
            batch = next(batches)
            state, metrics = step_fn(state, batch)
            if (step + 1) % cfg.push_every_steps == 0 \
                    and step + 1 < cfg.steps:
                t_push = time.perf_counter()
                if cfg.restart_per_update:
                    # The kill path the live push retires: stop every
                    # actor (in-flight rollouts die) and rebuild the pool
                    # from scratch on the new weights.
                    if prefetcher is not None:
                        prefetcher.close()
                    fleet.stop()
                    fleet = build_actor_fleet(state.params, cfg, spec)
                    owns_fleet = True
                    version += 1
                    restart_seconds.append(time.perf_counter() - t_push)
                    batches, prefetcher = _batches(
                        rollout_stream(fleet, cfg, counters), cfg, device)
                else:
                    # Every replica's placement copies the masters (cast
                    # to its serving dtype) before the call returns, so
                    # the next step's in-place update cannot reach them.
                    res = fleet.broadcast_weights(state.params)
                    version = res["version"]
                    push_seconds.append(time.perf_counter() - t_push)
                    if res["failed"]:
                        log(f"weight push v{version}: "
                            f"{len(res['failed'])} replica(s) failed "
                            f"({sorted(res['failed'])}); stragglers "
                            "converge next push")
                pushes += 1
                log(f"step={step + 1} loss={float(metrics['loss']):.4f} "
                    f"weights_version={version} pushes={pushes}")
    finally:
        if prefetcher is not None:
            prefetcher.close()
        try:
            fleet_metrics = fleet.metrics()
        except Exception:  # a best-effort snapshot
            fleet_metrics = {}
        if owns_fleet:
            fleet.stop()
    elapsed = time.perf_counter() - t0
    return {
        "step": cfg.steps,
        "loss": float(metrics["loss"]) if metrics else None,
        "pushes": pushes,
        "weights_version": version,
        "rollouts": counters["rollouts"],
        "rollout_tokens": counters["rollout_tokens"],
        "rollout_tokens_per_sec": counters["rollout_tokens"]
        / max(elapsed, 1e-9),
        "push_ms_avg": round(1e3 * (sum(push_seconds)
                                    / len(push_seconds)), 3)
        if push_seconds else 0.0,
        "restart_ms_avg": round(1e3 * (sum(restart_seconds)
                                       / len(restart_seconds)), 3)
        if restart_seconds else 0.0,
        "elapsed_s": round(elapsed, 3),
        "weights_installed": fleet_metrics.get("weights_installed", {}),
    }


def main(argv=None) -> int:
    """``python -m kubeflow_tpu_torch.train.rl '<json rl config>'``

    Actor addresses arrive via ``KUBEFLOW_TPU_RL_ACTORS`` (the RLJob
    operator injects the pool's pod DNS). When present, pushes go over
    each actor's ``:weights`` endpoint and rollouts over ``:predict``;
    without it the loop builds its in-process pool."""
    from kubeflow_tpu_torch.train.loop import publish_metrics

    argv = sys.argv[1:] if argv is None else argv
    overrides = json.loads(argv[0]) if argv else {}
    opt_cfg = OptimizerConfig(**overrides.pop("optimizer", {}))
    cfg = RLConfig(optimizer=opt_cfg, **overrides)
    fleet = None
    targets = [t for t in os.environ.get("KUBEFLOW_TPU_RL_ACTORS",
                                         "").split(",") if t]
    if targets:
        from kubeflow_tpu_torch.serving.remote_fleet import RemoteActorFleet

        fleet = RemoteActorFleet(targets, cfg.model,
                                 weights_max_lag=cfg.weights_max_lag)
    result = run_rl(cfg, fleet=fleet)
    publish_metrics(result)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
