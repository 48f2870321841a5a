"""PyTorch/CUDA port of the kubeflow_tpu compute path, for NVIDIA Hopper.

The package mirrors ``kubeflow_tpu``'s module names so each counterpart is
easy to find (``models/decode.py`` ports ``kubeflow_tpu/models/decode.py``
and so on), but it imports nothing from it: what it needs from a JAX-free
module there, it keeps its own copy of. The JAX package stays the
reference; the ``tests/test_torch_*.py`` files hold each ported function
against it on the same inputs.

Kernels that the JAX package wrote in Pallas for the TPU are written by
hand here: ``csrc/paged_decode.cu`` and ``csrc/flash_attention.cu`` (CUDA
C++, built with ``nvcc`` at first use into ``build/kubeflow_tpu_torch/``)
and ``ops/rms_norm_triton.py`` (Triton). A wrapper takes its kernel's plain
PyTorch version only for tensors that lie on the CPU; for a CUDA tensor it
launches the kernel or raises.

Entry points take ``device`` (default ``"cuda"``) and raise when CUDA is
absent unless the caller asked for ``"cpu"``.
"""
