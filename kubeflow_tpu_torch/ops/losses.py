"""Loss functions; counterpart of ``kubeflow_tpu/ops/losses.py``.

Cross entropy is computed in float32 from (bf16) logits with the
max-subtracted logsumexp, plus the z-loss regularizer that keeps logits
from drifting when training in low precision. Masked positions (label < 0)
contribute zero and are excluded from the normalizer.
``chunked_lm_head_loss`` (the ``loss_chunks > 0`` path) applies the LM
head and the same loss a chunk of rows at a time.

Over a mesh (``mesh=``, each rank holding its rows of the batch) the
normaliser is the GLOBAL count of valid targets, summed over the batch's
axes without a gradient: each rank's loss is its term of the loss JAX
computes over the whole batch, so the terms' gradients sum to JAX's
gradient. The metrics are the global values (the terms summed). Ranks of
the ``tensor`` axis hold the same rows and compute the same loss, so the
count and the metrics sum over the batch axes alone; the chunked loss
gathers a tensor rank's vocabulary block of each chunk's logits whole
(``gather_from_tensor``, whose gradient is the rank's slice). Under
context parallelism a rank holds a chunk of each row's tokens, and
``axes`` adds ``sequence`` to the axes the count and the metrics sum
over.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from kubeflow_tpu_torch.parallel.collectives import gather_from_tensor, psum_
from kubeflow_tpu_torch.parallel.mesh import BATCH_AXES, tensor_mesh


def batch_sum(x: torch.Tensor, mesh, axes=BATCH_AXES) -> torch.Tensor:
    """``x`` summed over the batch's mesh axes (``axes``: those the
    tokens are split over), without a gradient."""
    return psum_(x.detach().clone(), mesh, axes)


def _global_metrics(metrics: dict, mesh, axes) -> dict:
    """Each rank's loss terms summed into the global values; ``tokens``
    is global already."""
    keys = [k for k in metrics if k != "tokens"]
    total = batch_sum(torch.stack([metrics[k].float() for k in keys]), mesh,
                      axes)
    return {"tokens": metrics["tokens"],
            **{k: total[i] for i, k in enumerate(keys)}}


def _normaliser(count, mesh, axes):
    return torch.clamp_min(
        count if mesh is None else batch_sum(count, mesh, axes), 1.0)


def _nll_and_lse(logits, labels):
    """Per-position (nll, lse) in f32. The subtracted max is a detached
    value added back unchanged, so grad(lse) gains no one_hot(argmax)
    term. Negative labels gather index 0; callers mask them."""
    logits32 = logits.float()
    m = logits32.amax(dim=-1, keepdim=True).detach()
    lse = torch.log(torch.exp(logits32 - m).sum(dim=-1)) + m[..., 0]
    label_logit = torch.gather(
        logits32, -1, labels.clamp_min(0).long()[..., None])[..., 0]
    return lse - label_logit, lse


def softmax_cross_entropy(logits, labels, *, z_loss: float = 0.0,
                          where=None, mesh=None, axes=BATCH_AXES):
    """Mean token cross entropy. logits: [..., V]; labels: [...] int,
    negative = ignore. Returns (loss, metrics dict with "loss", "tokens"
    and, when ``z_loss``, "z_loss"); over ``mesh`` the loss is this
    rank's term (see the module docstring) of the loss over the tokens
    of ``axes``."""
    nll, lse = _nll_and_lse(logits, labels)
    mask = labels >= 0
    if where is not None:
        mask = mask & where
    maskf = mask.float()
    tokens = _normaliser(maskf.sum(), mesh, axes)
    loss = (nll * maskf).sum() / tokens
    metrics = {"loss": loss, "tokens": tokens}
    if z_loss:
        zl = z_loss * (torch.square(lse) * maskf).sum() / tokens
        metrics["z_loss"] = zl
        loss = loss + zl
    if mesh is not None:
        metrics = _global_metrics(metrics, mesh, axes)
    return loss, metrics


def _chunk_sums(x, head, labels, tmesh=None):
    """(sum of nll, sum of lse^2, tokens) over one chunk's unmasked rows;
    over ``tmesh`` (a tensor mesh) ``head`` is this rank's vocabulary
    block and the chunk's logits are gathered whole."""
    logits = x @ head
    if tmesh is not None:
        logits = gather_from_tensor(logits, tmesh)
    nll, lse = _nll_and_lse(logits, labels)
    maskf = (labels >= 0).float()
    return ((nll * maskf).sum(), (torch.square(lse) * maskf).sum(),
            maskf.sum())


def chunked_lm_head_loss(x, head, labels, *, z_loss: float = 0.0,
                         n_chunks: int = 4, mesh=None, axes=BATCH_AXES):
    """LM head matmul + cross entropy without ever materializing the full
    ``[N, V]`` logits. Rows go in ``n_chunks`` chunks, each under a
    checkpoint region while autograd records: the forward keeps only
    per-chunk sums, the backward recomputes a chunk's logits when it
    needs them. Numerics match :func:`softmax_cross_entropy` (the same
    logsumexp in f32, z-loss and masking), summed chunk by chunk as JAX's
    scan does.

    x: [N, D] final hidden states; head: [D, V] (over a mesh with a
    tensor axis, this rank's [D, V / tp] block, ``x`` already behind
    ``copy_to_tensor``); labels: [N] int (negative = ignore). Returns
    (loss, metrics) like the unchunked path, over ``mesh`` too.
    """
    n = x.shape[0]
    if n % n_chunks:
        raise ValueError(f"rows {n} not divisible by n_chunks {n_chunks}")
    rows = n // n_chunks
    tmesh = tensor_mesh(mesh)
    nll_sum = zsq_sum = tok_sum = torch.zeros((), dtype=torch.float32,
                                              device=x.device)
    for i in range(n_chunks):
        args = (x[i * rows:(i + 1) * rows], head,
                labels[i * rows:(i + 1) * rows], tmesh)
        if torch.is_grad_enabled():
            sums = checkpoint(_chunk_sums, *args, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            sums = _chunk_sums(*args)
        nll_sum, zsq_sum, tok_sum = (nll_sum + sums[0], zsq_sum + sums[1],
                                     tok_sum + sums[2])
    tokens = _normaliser(tok_sum, mesh, axes)
    loss = nll_sum / tokens
    metrics = {"loss": loss, "tokens": tokens}
    if z_loss:
        zl = z_loss * zsq_sum / tokens
        metrics["z_loss"] = zl
        loss = loss + zl
    if mesh is not None:
        metrics = _global_metrics(metrics, mesh, axes)
    return loss, metrics
