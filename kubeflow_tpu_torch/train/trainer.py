"""Single-device train step; counterpart of ``kubeflow_tpu/train/trainer.py``.

One step: forward, backward (``torch.autograd.grad``), optimizer update.
The JAX step is one jitted function with donated state; here the step
runs eagerly and updates the parameters and the optimizer slots IN PLACE
under ``torch.no_grad()``, which is what donation buys JAX. The step
returns the same metrics as JAX's: ``loss``, ``z_loss``, ``tokens``,
``grad_norm`` (of the unclipped gradients) and ``step``, as 0-d tensors
that stay on the device until the caller reads them.

A mesh (data, FSDP or tensor parallelism) is not yet ported and raises.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from kubeflow_tpu_torch.device import resolve_device
from kubeflow_tpu_torch.train.optimizers import (
    OptimizerConfig,
    build as build_opt,
    global_norm,
    torch_dtype,
)
from kubeflow_tpu_torch.weights import _unflatten, flatten


@dataclass
class TrainState:
    step: int
    params: dict      # the model's nested parameter dict (master weights)
    opt_state: dict


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise ValueError("training over a mesh is not yet ported to the "
                         "PyTorch package; pass mesh=None")


def init_state(generator: torch.Generator, model, opt_cfg: OptimizerConfig,
               mesh=None, *, device: str | torch.device = "cuda"
               ) -> TrainState:
    """Float32 master parameters from ``generator`` and the optimizer's
    zero state, on ``device``."""
    _no_mesh(mesh)
    params = model.init(model.config, generator=generator,
                        device=resolve_device(device),
                        param_dtype=torch.float32)
    return TrainState(step=0, params=params,
                      opt_state=build_opt(opt_cfg).init(flatten(params)))


def build_train_step(model, opt_cfg: OptimizerConfig, mesh=None, *,
                     accum_steps: int = 1):
    """Returns ``step_fn(state, batch) -> (state, metrics)``; ``state`` is
    updated in place and returned.

    ``accum_steps > 1``: batch leaves carry a leading [accum_steps, ...]
    axis (``data.stack_microbatches``); the step runs the microbatches in
    turn, accumulating the MEAN gradient in the gradient dtype
    (``opt_cfg.grad_dtype`` or the parameter dtype) before ONE optimizer
    update, and averages the scalar metrics over the microbatches."""
    _no_mesh(mesh)
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    opt = build_opt(opt_cfg)
    grad_dtype = torch_dtype(opt_cfg.grad_dtype) if opt_cfg.grad_dtype \
        else None

    def grads_of(params: dict, batch: dict):
        flat = flatten(params)
        # Leaves of the autograd graph: the master weights themselves, or
        # a view of them in grad_dtype (JAX differentiates p.astype(gdt)).
        leaves = {k: (p.detach().to(grad_dtype) if grad_dtype
                      and p.is_floating_point() else p.detach())
                  .requires_grad_(True) for k, p in flat.items()}
        loss, metrics = model.loss_fn(_unflatten(leaves), batch,
                                      model.config)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        metrics = {k: v.detach() for k, v in metrics.items()}
        return metrics, dict(zip(leaves, grads))

    def apply_update(state: TrainState, metrics: dict, grads: dict):
        metrics["grad_norm"] = global_norm(grads.values())
        metrics["step"] = torch.tensor(state.step)
        with torch.no_grad():
            opt.update(grads, state.opt_state, flatten(state.params))
        state.step += 1
        return state, metrics

    def step_fn(state: TrainState, batch: dict):
        metrics, grads = grads_of(state.params, batch)
        return apply_update(state, metrics, grads)

    def accum_step_fn(state: TrainState, batch: dict):
        acc, sums = None, {}
        for i in range(accum_steps):
            metrics, grads = grads_of(state.params,
                                      {k: v[i] for k, v in batch.items()})
            # Divide per microbatch: the accumulator holds a running MEAN,
            # so a low-precision gradient dtype never sees a k-times sum.
            if acc is None:
                acc = {k: torch.zeros_like(g) for k, g in grads.items()}
            for k, g in grads.items():
                acc[k] += g.to(acc[k].dtype) / accum_steps
            for k, v in metrics.items():
                sums[k] = sums.get(k, 0.0) + v
        return apply_update(state, {k: v / accum_steps
                                    for k, v in sums.items()}, acc)

    return accum_step_fn if accum_steps > 1 else step_fn
