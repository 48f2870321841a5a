"""Compute ops of the port.

- :mod:`~kubeflow_tpu_torch.ops.attention` — paged single-token decode
  attention (CUDA kernel ``csrc/paged_decode.cu`` + plain version).
- :mod:`~kubeflow_tpu_torch.ops.norms` — RMSNorm (Triton kernel opt-in) and
  LayerNorm.
- :mod:`~kubeflow_tpu_torch.ops.rotary` — rotary position embeddings.
"""
