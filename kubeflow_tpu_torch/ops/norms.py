"""Normalization ops; counterpart of ``kubeflow_tpu/ops/norms.py``.

RMSNorm has a plain PyTorch path (what the model calls, as the JAX model
calls the XLA path) and an opt-in kernel path, ``implementation="kernel"``
(JAX's ``"pallas"``): :class:`_RmsNormKernel`, whose forward is the Triton
kernel of ``ops/rms_norm_triton.py`` for CUDA tensors (this module's plain
version for CPU tensors) and whose backward is the closed-form VJP of
JAX's ``_rms_norm_fused_bwd`` in plain PyTorch, as JAX's is plain XLA.
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
    return _RmsNormKernel.apply(x, weight, eps)


class _RmsNormKernel(torch.autograd.Function):
    """The opt-in kernel path with its gradient. The Triton kernel writes
    into a fresh tensor that autograd cannot see through, so the backward
    is given here: d/dx [x·r(x)·w] = r·gw − r³·x·mean(gw·x) with gw = g·w,
    and dw = Σ g·x·r over every axis but the last, in f32."""

    @staticmethod
    def forward(ctx, x, weight, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        if x.device.type == "cpu":
            return _rms_norm_plain(x, weight, eps)
        from kubeflow_tpu_torch.ops.rms_norm_triton import rms_norm_triton

        return rms_norm_triton(x.contiguous(), weight.contiguous(), eps)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        x32, g32, w32 = x.float(), g.float(), weight.float()
        r = torch.rsqrt(torch.mean(torch.square(x32), dim=-1, keepdim=True)
                        + ctx.eps)
        gw = g32 * w32
        dx = r * gw - r ** 3 * x32 * torch.mean(gw * x32, dim=-1,
                                                keepdim=True)
        dw = torch.sum(g32 * x32 * r, dim=tuple(range(x32.dim() - 1)))
        return dx.to(x.dtype), dw.to(weight.dtype), None


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
