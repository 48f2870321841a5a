"""Normalization ops; counterpart of ``kubeflow_tpu/ops/norms.py``.

RMSNorm has a plain PyTorch path (what the model calls, as the JAX model
calls the XLA path) and an opt-in kernel path, ``implementation="kernel"``
(JAX's ``"pallas"``): the Triton kernel of ``ops/rms_norm_triton.py`` for
CUDA tensors, this module's plain version for CPU tensors.
"""

from __future__ import annotations

import torch


def rms_norm(x, weight, *, eps: float = 1e-6,
             implementation: str | None = None):
    """y = x / rms(x) * weight over the last dim. x: [..., D], weight: [D].
    Computed in float32; the output takes x's dtype."""
    if implementation is None:
        return _rms_norm_plain(x, weight, eps)
    if implementation != "kernel":
        raise ValueError(f"unknown implementation {implementation!r}")
    if x.device.type == "cpu":
        return _rms_norm_plain(x, weight, eps)
    from kubeflow_tpu_torch.ops.rms_norm_triton import rms_norm_triton

    return rms_norm_triton(x, weight, eps)


def _rms_norm_plain(x, weight, eps):
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * weight.float()).to(x.dtype)


def layer_norm(x, weight, bias, *, eps: float = 1e-6):
    x32 = x.float()
    mean = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x32 - mean), dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)
