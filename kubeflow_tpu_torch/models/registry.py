"""Model registry: name → ModelSpec, for the three families.

Counterpart of ``kubeflow_tpu/models/registry.py``: the transformer LM
(dense and mixture-of-experts presets), the BERT encoder and the ResNet
classifier, looked up in that order.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

from kubeflow_tpu_torch.models import bert, resnet, transformer

_FAMILIES = (("transformer", transformer), ("bert", bert),
             ("resnet", resnet))


@dataclass(frozen=True)
class ModelSpec:
    name: str
    family: str
    config: Any
    init: Callable          # (cfg, *, generator, device, param_dtype) -> params
    apply: Callable         # (params, inputs, cfg, *, mesh=None) -> outputs
    loss_fn: Callable       # (params, batch, cfg, *, mesh=None) -> (loss, metrics)
    partition_rules: Callable       # cfg -> [PartitionRule]
    batch_partition_spec: Callable  # cfg -> spec of a batch leaf
    # Optional non-gradient state channel: (params,
    # metrics["_state_updates"]) -> params, applied by the trainer after
    # the optimizer step (ResNet's batch-norm running statistics).
    update_state: Callable | None = None
    # (cfg, mesh) -> None; raises for a mesh whose degrees do not divide
    # the family's shapes.
    check_mesh: Callable | None = None


def get_model(name: str, **overrides) -> ModelSpec:
    for family, module in _FAMILIES:
        if name in module.PRESETS:
            return ModelSpec(
                name=name, family=family,
                config=module.config(name, **overrides),
                init=module.init, apply=module.apply,
                loss_fn=module.loss_fn,
                partition_rules=module.partition_rules,
                batch_partition_spec=module.batch_partition_spec,
                update_state=getattr(module, "update_state", None),
                check_mesh=getattr(module, "check_mesh", None))
    raise KeyError(
        f"unknown model {name!r}; available: {sorted(list_models())}")


def list_models() -> list[str]:
    return [name for _, module in _FAMILIES for name in module.PRESETS]
