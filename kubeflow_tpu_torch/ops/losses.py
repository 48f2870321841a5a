"""Loss functions; counterpart of ``kubeflow_tpu/ops/losses.py``.

Cross entropy is computed in float32 from (bf16) logits with the
max-subtracted logsumexp, plus the z-loss regularizer that keeps logits
from drifting when training in low precision. Masked positions (label < 0)
contribute zero and are excluded from the normalizer.

``chunked_lm_head_loss`` (the ``loss_chunks > 0`` path) is not yet ported;
``models/transformer.py`` raises before reaching it.
"""

from __future__ import annotations

import torch


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
                          where=None):
    """Mean token cross entropy. logits: [..., V]; labels: [...] int,
    negative = ignore. Returns (loss, metrics dict with "loss", "tokens"
    and, when ``z_loss``, "z_loss")."""
    nll, lse = _nll_and_lse(logits, labels)
    mask = labels >= 0
    if where is not None:
        mask = mask & where
    maskf = mask.float()
    tokens = torch.clamp_min(maskf.sum(), 1.0)
    loss = (nll * maskf).sum() / tokens
    metrics = {"loss": loss, "tokens": tokens}
    if z_loss:
        zl = z_loss * (torch.square(lse) * maskf).sum() / tokens
        metrics["z_loss"] = zl
        loss = loss + zl
    return loss, metrics
