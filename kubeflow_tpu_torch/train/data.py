"""Training data; counterpart of ``kubeflow_tpu/train/data.py``.

The synthetic generators of the three families draw from the same numpy
generator with the same calls in the same order as the JAX package, so a
(seed, step) gives the same batch in both, bit for bit: tokens for the
transformer, tokens and MLM labels for BERT, NHWC images and labels for
ResNet. Batches are host-resident numpy dicts; :func:`place_batch` copies
one to the device as torch tensors.

Over a mesh each process feeds its own rows, as JAX's
``make_array_from_process_local_data`` takes them: the global batch is
the processes' batches one after another along the batch dim (the batch
axes ``("data", "fsdp")``, data major), and a process's tensor IS its
shard, so placing it is a copy. :func:`local_rows` cuts a process's rows
out of a global batch; under context parallelism :func:`local_tokens`
cuts a ``sequence`` rank's chunk of their tokens (the inputs/targets
pair, whose length the sequence degree divides).
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch


def synthetic_batch(model, batch_size: int, seq_len: int = 512,
                    seed: int = 0) -> dict:
    """One host-resident numpy batch matching the model family's loss_fn."""
    rng = np.random.default_rng(seed)
    cfg = model.config
    if model.family == "transformer":
        tokens = rng.integers(0, cfg.vocab_size, (batch_size, seq_len + 1),
                              dtype=np.int32)
        if cfg.context_parallel:
            return {"inputs": tokens[:, :-1], "targets": tokens[:, 1:]}
        return {"tokens": tokens}
    if model.family == "bert":
        tokens = rng.integers(0, cfg.vocab_size, (batch_size, seq_len),
                              dtype=np.int32)
        mask = rng.random((batch_size, seq_len)) < 0.15
        labels = np.where(mask, tokens, -1).astype(np.int32)
        return {"tokens": tokens, "mlm_labels": labels}
    if model.family == "resnet":
        images = rng.standard_normal(
            (batch_size, cfg.image_size, cfg.image_size, 3), np.float32)
        labels = rng.integers(0, cfg.num_classes, (batch_size,), np.int32)
        return {"images": images, "labels": labels}
    raise ValueError(f"unknown model family {model.family}")


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


def local_rows(batch: dict, rank: int, n_ranks: int, *,
               microbatched: bool = False) -> dict:
    """Rank ``rank``'s block of a global host batch split ``n_ranks``
    ways along the batch dim (dim 1 of ``microbatched`` leaves, whose dim
    0 is the accumulation axis): its rows under the batch spec."""
    def rows(x):
        x = np.asarray(x)
        dim = 1 if microbatched else 0
        n = x.shape[dim] // n_ranks
        if n * n_ranks != x.shape[dim]:
            raise ValueError(f"batch of {x.shape[dim]} rows does not split "
                             f"over {n_ranks} ranks")
        return np.take(x, range(rank * n, (rank + 1) * n), axis=dim)

    return {k: rows(v) for k, v in batch.items()}


def local_tokens(batch: dict, rank: int, n_ranks: int, *,
                 microbatched: bool = False) -> dict:
    """Rank ``rank``'s chunk of the token dim (dim 1, dim 2 of
    ``microbatched`` leaves) split ``n_ranks`` ways: its tokens under the
    batch spec of context parallelism (``("data", "fsdp"), "sequence"``)."""
    def chunk(x):
        x = np.asarray(x)
        dim = 2 if microbatched else 1
        n = x.shape[dim] // n_ranks
        if n * n_ranks != x.shape[dim]:
            raise ValueError(f"{x.shape[dim]} tokens a row do not split "
                             f"over {n_ranks} sequence ranks")
        return np.take(x, range(rank * n, (rank + 1) * n), axis=dim)

    return {k: chunk(v) for k, v in batch.items()}


def place_batch(batch: dict, device: torch.device) -> dict:
    """Copy a host batch (over a mesh: this process's rows) to ``device``
    (int32 arrays stay int32)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}
