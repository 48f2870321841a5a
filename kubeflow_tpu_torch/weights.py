"""Parameter trees handed across as numpy arrays.

The JAX package's parameter pytree (``kubeflow_tpu/models/transformer.py:
init``), with every leaf converted to a numpy array, becomes the port's
parameter dict with the same nesting. Leaves are named with the ``a/b/c``
path convention of ``kubeflow_tpu/parallel/sharding.py:path_str``, copied
here so names match without importing the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from kubeflow_tpu_torch.device import resolve_device
from kubeflow_tpu_torch.models.transformer import (
    NORM_LEAVES,
    TransformerConfig,
)


def path_str(key_path) -> str:
    """Render a key path (a sequence of dict keys or indices) as 'a/b/c'."""
    return "/".join(str(k) for k in key_path)


def flatten(tree, prefix=()) -> dict[str, object]:
    """{'a/b/c': leaf} over a nested dict."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flatten(v, (*prefix, k)))
        return out
    return {path_str(prefix): tree}


def _unflatten(flat: dict[str, object]) -> dict:
    tree: dict = {}
    for path, leaf in flat.items():
        node = tree
        *parents, last = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return tree


def params_from_numpy(tree, cfg: TransformerConfig,
                      device: str | torch.device = "cuda",
                      dtype: torch.dtype | None = None) -> dict:
    """Numpy parameter tree → the port's parameter dict on ``device``.

    By default matmul and embedding weights land in ``cfg.dtype`` (the JAX
    model casts them to it at every use, so storing the cast once computes
    the same thing for serving); the norm weights stay float32, as
    ``rms_norm`` reads them. ``dtype=torch.float32`` keeps every leaf in
    float32: training's master weights, as the JAX trainer holds them."""
    dev = resolve_device(device)
    flat = {}
    for path, leaf in flatten(tree).items():
        arr = np.array(leaf, dtype=np.float32)  # a writable copy
        leaf_dtype = (torch.float32 if path in NORM_LEAVES
                      else dtype or cfg.dtype)
        flat[path] = torch.from_numpy(arr).to(device=dev, dtype=leaf_dtype)
    return _unflatten(flat)


def params_to_numpy(params) -> dict:
    """The port's parameter dict → a nested dict of float32 numpy arrays
    (the inverse of :func:`params_from_numpy`), so tests compare trees."""
    # np.array copies: a float32 CPU tensor's .numpy() shares its memory,
    # and the trainer updates parameters in place.
    return _unflatten({path: np.array(leaf.detach().float().cpu())
                       for path, leaf in flatten(params).items()})
