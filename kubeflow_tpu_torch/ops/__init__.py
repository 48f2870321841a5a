"""Compute ops of the port.

- :mod:`~kubeflow_tpu_torch.ops.attention` — GQA flash attention with
  its backward (CUDA kernels ``csrc/flash_attention.cu`` + plain
  versions) and paged single-token decode attention (CUDA kernel
  ``csrc/paged_decode.cu`` + plain version).
- :mod:`~kubeflow_tpu_torch.ops.losses` — softmax cross entropy with
  z-loss.
- :mod:`~kubeflow_tpu_torch.ops.norms` — RMSNorm (Triton kernel opt-in,
  with its backward) and LayerNorm.
- :mod:`~kubeflow_tpu_torch.ops.rotary` — rotary position embeddings.
"""
