"""Rotary position embeddings (RoPE); counterpart of
``kubeflow_tpu/ops/rotary.py``. Plain PyTorch: two multiplies and an add
per element, no kernel of its own."""

from __future__ import annotations

import torch


def rotary_frequencies(head_dim: int, max_len: int, *,
                       theta: float = 10000.0, device=None):
    """cos/sin tables [max_len, head_dim//2], float32."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    inv_freq = 1.0 / (theta ** exps)
    angles = torch.outer(
        torch.arange(max_len, dtype=torch.float32, device=device), inv_freq)
    return torch.cos(angles), torch.sin(angles)


def apply_rotary(x, cos, sin, *, positions=None):
    """Rotate pairs (x[..., :D/2], x[..., D/2:]). x: [B, T, H, D].

    ``positions`` ([B, T] int) selects rows of the tables; defaults to
    0..T-1. Positions must lie inside the tables (torch raises where
    JAX would clamp)."""
    t = x.shape[1]
    if positions is None:
        c = cos[:t][None, :, None, :]
        s = sin[:t][None, :, None, :]
    else:
        c = cos[positions.long()][:, :, None, :]
        s = sin[positions.long()][:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    rotated = torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)
    return rotated.to(x.dtype)
