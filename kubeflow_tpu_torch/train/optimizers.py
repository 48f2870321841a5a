"""Optimizer and schedule presets; counterpart of
``kubeflow_tpu/train/optimizers.py``.

The JAX package builds these from optax. Here each is written by hand on
tensors to optax's formulas (optax 0.2), because ``torch.optim`` differs
from optax where it matters: ``clip_grad_norm_`` adds 1e-6 to the norm and
scales even below the threshold's edge, AdamW decays by ``lr * wd`` before
the Adam step instead of adding ``wd * p`` to the update, and there is no
Adafactor. An optimizer is an :class:`Optimizer` with ``init(params)`` and
``update(grads, state, params)``; ``update`` changes the parameters and
the state IN PLACE (JAX returns new trees from donated ones) and must run
under ``torch.no_grad()``.

Parameters, gradients and state are flat ``{"a/b/c": tensor}`` dicts.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    grad_clip_norm: float = 1.0
    min_lr_ratio: float = 0.1
    momentum: float = 0.9  # sgd only
    # adamw/adam first-moment dtype; "bfloat16" halves that slot (the
    # second moment stays in the parameter dtype).
    mu_dtype: str | None = None
    # Differentiate w.r.t. a view of the master weights in this dtype, so
    # the gradients materialize at 2 bytes a parameter ("bfloat16").
    grad_dtype: str | None = None


def torch_dtype(name: str) -> torch.dtype:
    """'bfloat16' / 'float32' / ... → the torch dtype of that name."""
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dtype


def schedule(cfg: OptimizerConfig):
    """Linear warmup from 0 to the peak, then cosine decay to
    min_lr_ratio·peak: optax's ``warmup_cosine_decay_schedule`` with
    ``decay_steps = max(total_steps, warmup_steps + 1)``. The first update
    (count 0) has learning rate 0."""
    peak = cfg.learning_rate
    warmup = cfg.warmup_steps
    decay_steps = max(cfg.total_steps, warmup + 1) - warmup
    end = peak * cfg.min_lr_ratio
    alpha = 0.0 if peak == 0.0 else end / peak

    def lr(count: int) -> float:
        if count < warmup:
            return peak * count / warmup
        c = min(count - warmup, decay_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * c / decay_steps))
        return peak * ((1.0 - alpha) * cosine + alpha)

    return lr


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm),
    accumulated in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(t.float()))
                          for t in tensors))


def _clip_by_global_norm(grads: dict, max_norm: float) -> dict:
    """optax.clip_by_global_norm: unchanged while the norm is below
    ``max_norm``, else ``g / norm * max_norm``. No epsilon; no host sync."""
    g_norm = global_norm(grads.values())
    keep = g_norm < max_norm
    return {k: torch.where(keep, g, g / g_norm.to(g.dtype) * max_norm)
            for k, g in grads.items()}


def _factored_dims(shape) -> tuple[int, int] | None:
    """The two largest axes when the smaller of them is >= 128 (optax's
    ``_factored_dims`` with min_dim_size_to_factor=128), else None."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < 128:
        return None
    return int(order[-2]), int(order[-1])


class Optimizer:
    """A gradient transformation chain of one named optimizer after
    global-norm clipping, applied in place."""

    def __init__(self, cfg: OptimizerConfig):
        if cfg.name not in ("adamw", "adam", "sgd", "adafactor"):
            raise ValueError(f"unknown optimizer {cfg.name!r}")
        self.cfg = cfg
        self.lr = schedule(cfg)
        self.mu_dtype = torch_dtype(cfg.mu_dtype) if cfg.mu_dtype else None

    def init(self, params: dict) -> dict:
        """State: the update count and the per-leaf slots."""
        name = self.cfg.name
        state: dict = {"count": 0}
        if name in ("adamw", "adam"):
            state["mu"] = {k: torch.zeros_like(p, dtype=self.mu_dtype)
                           for k, p in params.items()}
            state["nu"] = {k: torch.zeros_like(p)
                           for k, p in params.items()}
        elif name == "sgd":
            state["trace"] = {k: torch.zeros_like(p)
                              for k, p in params.items()}
        else:
            state["v_row"], state["v_col"], state["v"] = {}, {}, {}
            for k, p in params.items():
                dims = _factored_dims(p.shape)
                if dims is None:
                    state["v"][k] = torch.zeros_like(p)
                else:
                    d1, d0 = dims
                    state["v_row"][k] = p.new_zeros(
                        [n for i, n in enumerate(p.shape) if i != d0])
                    state["v_col"][k] = p.new_zeros(
                        [n for i, n in enumerate(p.shape) if i != d1])
        return state

    def update(self, grads: dict, state: dict, params: dict) -> None:
        """One optimizer step: clip, transform, ``p += update``; params and
        state change in place."""
        if self.cfg.grad_clip_norm:
            grads = _clip_by_global_norm(grads, self.cfg.grad_clip_norm)
        count = state["count"]
        lr = self.lr(count)
        step = getattr(self, f"_{self.cfg.name}")
        for k, p in params.items():
            p.add_(step(k, grads[k], p, state, count, lr).to(p.dtype))
        state["count"] = count + 1

    # Each returns the update of one leaf and advances its slots.

    def _adam_direction(self, k, g, state, count):
        cfg = self.cfg
        # JAX rounds the weak-typed b1 to a bf16 mu's dtype before the
        # product; a 0-d tensor of mu's dtype does the same here.
        mu_old = state["mu"][k]
        mu = (1 - cfg.b1) * g + torch.tensor(cfg.b1, dtype=mu_old.dtype) \
            * mu_old
        nu = state["nu"][k]
        nu.copy_((1 - cfg.b2) * g * g + cfg.b2 * nu)
        t = count + 1
        mu_hat = mu / (1 - cfg.b1 ** t)
        nu_hat = nu / (1 - cfg.b2 ** t)
        state["mu"][k].copy_(mu)  # cast to mu_dtype on the store
        return mu_hat / (torch.sqrt(nu_hat) + cfg.eps)

    def _adam(self, k, g, p, state, count, lr):
        return -lr * self._adam_direction(k, g, state, count)

    def _adamw(self, k, g, p, state, count, lr):
        u = self._adam_direction(k, g, state, count)
        return -lr * (u + self.cfg.weight_decay * p)

    def _sgd(self, k, g, p, state, count, lr):
        trace = state["trace"][k]
        trace.copy_(g + self.cfg.momentum * trace)
        return -lr * trace

    def _adafactor(self, k, g, p, state, count, lr):
        """optax.adafactor(lr, min_dim_size_to_factor=128): decay_rate 0.8,
        eps 1e-30, update clipped to block RMS 1, scaled by lr and by the
        parameter's RMS (at least 1e-3), no momentum."""
        decay = 1.0 - (count + 1.0) ** -0.8
        g_sq = g.float() * g.float() + 1e-30
        dims = _factored_dims(p.shape)
        if dims is not None:
            d1, d0 = dims
            v_row, v_col = state["v_row"][k], state["v_col"][k]
            v_row.copy_(decay * v_row + (1 - decay) * g_sq.mean(dim=d0))
            v_col.copy_(decay * v_col + (1 - decay) * g_sq.mean(dim=d1))
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            row_col_mean = v_row.mean(dim=reduced_d1, keepdim=True)
            row_factor = (v_row / row_col_mean) ** -0.5
            col_factor = v_col ** -0.5
            u = (g * row_factor.unsqueeze(d0)) * col_factor.unsqueeze(d1)
        else:
            v = state["v"][k]
            v.copy_(decay * v + (1 - decay) * g_sq)
            u = g * v ** -0.5
        u = u / torch.clamp_min(torch.sqrt(torch.mean(u * u)), 1.0)
        u = lr * u
        p_rms = torch.sqrt(torch.mean(torch.square(p.float())))
        u = u * torch.where(p_rms <= 1e-3, 1e-3, p_rms)
        return -u


def build(cfg: OptimizerConfig) -> Optimizer:
    return Optimizer(cfg)
