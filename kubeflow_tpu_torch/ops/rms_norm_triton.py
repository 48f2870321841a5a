"""RMSNorm forward as a Triton kernel.

Replaces the Pallas kernel ``kubeflow_tpu/ops/norms.py:_rms_norm_pallas``
(body ``_rms_kernel``): ``y = x * rsqrt(mean(x²) + eps) * w`` in float32,
written in x's dtype. The plain version is
``kubeflow_tpu_torch/ops/norms.py:_rms_norm_plain``.

Bound on the H100: bytes. One row reduction and one elementwise pass do
about 4 operations per element against 4 bytes moved per bf16 element (x
read, y written), far below the card's 295 operations per byte, so the
least time is ``(2·rows·D·itemsize + 4·D) / 3.35 TB/s``. The design keeps
that single pass: one program normalises one row held whole in registers
(BLOCK_D = next power of two ≥ D), so x is read once and y written once.

``triton`` is imported inside the launching function: modules of the port
import on machines without it.
"""

from __future__ import annotations

import functools

import torch

from kubeflow_tpu_torch import kernels


@functools.cache
def _kernel():
    import triton
    import triton.language as tl

    @triton.jit
    def rms_kernel(x_ptr, w_ptr, y_ptr, d, eps, BLOCK_D: tl.constexpr):
        row = tl.program_id(0)
        cols = tl.arange(0, BLOCK_D)
        mask = cols < d
        x = tl.load(x_ptr + row * d + cols, mask=mask, other=0.0)
        x = x.to(tl.float32)
        var = tl.sum(x * x, axis=0) / d
        y = x * tl.rsqrt(var + eps)
        w = tl.load(w_ptr + cols, mask=mask, other=0.0).to(tl.float32)
        tl.store(y_ptr + row * d + cols,
                 (y * w).to(y_ptr.dtype.element_ty), mask=mask)

    return triton, rms_kernel


def rms_norm_triton(x: torch.Tensor, weight: torch.Tensor,
                    eps: float) -> torch.Tensor:
    """Launch the kernel on CUDA tensors; raises on anything else."""
    if x.device.type != "cuda" or weight.device != x.device:
        raise ValueError("rms_norm_triton needs x and weight on one CUDA "
                         f"device, got {x.device} and {weight.device}")
    if x.dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise ValueError(f"unsupported x dtype {x.dtype}")
    d = x.shape[-1]
    if weight.shape != (d,) or weight.dtype != torch.float32:
        raise ValueError(f"weight must be float32 [{d}], got "
                         f"{weight.dtype} {tuple(weight.shape)}")
    if not (x.is_contiguous() and weight.is_contiguous()):
        raise ValueError("rms_norm_triton needs contiguous inputs")
    rows = x.numel() // d if d else 0
    y = torch.empty_like(x)
    if rows == 0:
        return y
    triton, rms_kernel = _kernel()
    block_d = triton.next_power_of_2(d)
    with torch.cuda.device(x.device):
        rms_kernel[(rows,)](x, weight, y, d, float(eps), BLOCK_D=block_d,
                            num_warps=8 if block_d >= 2048 else 4)
    kernels.LAUNCHES["rms_norm"] += 1
    return y
