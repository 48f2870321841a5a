"""Model registry: name → ModelSpec (transformer family only so far).

Counterpart of ``kubeflow_tpu/models/registry.py``. BERT and ResNet join
the registry when their modules are ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

from kubeflow_tpu_torch.models import transformer


@dataclass(frozen=True)
class ModelSpec:
    name: str
    family: str
    config: Any
    init: Callable          # (cfg, *, generator, device, param_dtype) -> params
    apply: Callable         # (params, tokens, cfg, *, mesh=None) -> logits
    loss_fn: Callable       # (params, batch, cfg, *, mesh=None) -> (loss, metrics)


def get_model(name: str, **overrides) -> ModelSpec:
    if name in transformer.PRESETS:
        return ModelSpec(name=name, family="transformer",
                         config=transformer.config(name, **overrides),
                         init=transformer.init, apply=transformer.apply,
                         loss_fn=transformer.loss_fn)
    raise KeyError(
        f"unknown model {name!r}; available: {sorted(list_models())}")


def list_models() -> list[str]:
    return list(transformer.PRESETS)
