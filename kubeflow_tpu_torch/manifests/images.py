"""Container images of the port's workloads; counterpart of
``kubeflow_tpu/manifests/images.py``'s ``JAX_TPU``, ``SERVING`` and
``NOTEBOOK``.

One image serves and trains: PyTorch built for CUDA 12.8, the CUDA
toolkit (``nvcc`` for the hand-written kernels), CUTLASS's headers,
Triton, numpy/scipy/einops and ``kubeflow_tpu_torch``, with no JAX. Its
recipe is ``docker_torch/Dockerfile``.
"""

__version__ = "0.1.0"  # kubeflow_tpu/version.py's, which the image tag follows

TORCH_CUDA = f"ghcr.io/kubeflow-tpu/torch-cuda:{__version__}"

# The notebook image: the port's image plus JupyterLab (the
# ``notebook`` stage of the same recipe); JAX's ``NOTEBOOK`` ships JAX
# and libtpu.
NOTEBOOK = f"ghcr.io/kubeflow-tpu/torch-notebook:{__version__}"

# The GPU resource a pod requests (the device plugin's name).
GPU_RESOURCE = "nvidia.com/gpu"


def gpu_resources(gpus: int) -> dict | None:
    """Pod resources requesting ``gpus`` GPUs; None when 0 (a CPU pod).
    The counterpart of ``kubeflow_tpu/apis/jobs.py``'s ``tpu_resources``."""
    if not gpus:
        return None
    return {
        "limits": {GPU_RESOURCE: gpus},
        "requests": {GPU_RESOURCE: gpus},
    }
