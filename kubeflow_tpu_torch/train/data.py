"""Training data; counterpart of ``kubeflow_tpu/train/data.py`` for the
transformer family.

The synthetic generator draws from the same numpy generator with the same
calls as the JAX package, so a (seed, step) gives the same tokens in both.
Batches are host-resident numpy dicts; :func:`place_batch` copies one to
the device as torch tensors (there is no mesh to shard it over yet).
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch


def synthetic_batch(model, batch_size: int, seq_len: int = 512,
                    seed: int = 0) -> dict:
    """One host-resident numpy batch matching the model family's loss_fn."""
    if model.family != "transformer":
        raise ValueError(f"synthetic data for the {model.family!r} family "
                         "is not yet ported")
    rng = np.random.default_rng(seed)
    cfg = model.config
    tokens = rng.integers(0, cfg.vocab_size, (batch_size, seq_len + 1),
                          dtype=np.int32)
    if cfg.context_parallel:
        return {"inputs": tokens[:, :-1], "targets": tokens[:, 1:]}
    return {"tokens": tokens}


def synthetic_stream(model, batch_size: int, seq_len: int = 512,
                     seed: int = 0, start_step: int = 0) -> Iterator[dict]:
    """Stateless in (seed, step): a run started at ``start_step`` sees the
    batches an uninterrupted run would have seen from there."""
    step = start_step
    while True:
        yield synthetic_batch(model, batch_size, seq_len, seed=seed + step)
        step += 1


def stack_microbatches(stream: Iterator[dict],
                       accum_steps: int) -> Iterator[dict]:
    """[accum_steps, batch, ...] stacked host batches, the unit the
    gradient-accumulation train step loops over. Consumes ``accum_steps``
    stream entries per yield, in order."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    while True:
        micro = [next(stream) for _ in range(accum_steps)]
        yield {k: np.stack([m[k] for m in micro]) for k in micro[0]}


def place_batch(batch: dict, device: torch.device) -> dict:
    """Copy a host batch to ``device`` (int32 token arrays stay int32)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}
