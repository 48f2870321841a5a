"""The port's manifest layer: prototypes that deploy and run the PyTorch
package on NVIDIA GPUs; counterpart of ``kubeflow_tpu/manifests``.

``python -m kubeflow_tpu_torch.manifests gpu-serving --param name=llama
--param model_name=llama-1b`` prints the objects. The registry
(:mod:`.core`) is the port's own: JAX's prototypes never load into it.
"""

from kubeflow_tpu_torch.manifests.core import (
    ParamSpec,
    Prototype,
    PrototypeError,
    REQUIRED,
    all_prototypes,
    generate,
    get_prototype,
    load_all_packages,
    prototype,
)

__all__ = [
    "ParamSpec",
    "Prototype",
    "PrototypeError",
    "REQUIRED",
    "all_prototypes",
    "generate",
    "get_prototype",
    "load_all_packages",
    "prototype",
]
