"""Pipeline parallelism: the GPipe schedule over the ``pipeline`` mesh
axis; counterpart of ``kubeflow_tpu/parallel/pipeline.py``.

The stacked ``[L, ...]`` layer leaves are sharded on their L dim over
``pipeline``: stage ``s`` holds the contiguous layers
``stage_layer_ranges(L, S)[s]``. :func:`pipeline_apply` splits the batch
into ``n_micro`` contiguous microbatches and runs ``n_micro + S - 1``
steps; at step ``t`` stage ``s`` runs microbatch ``t - s`` through its
layers, and every stage sends its output one stage on with
:func:`~kubeflow_tpu_torch.parallel.collectives.ring_permute` (shift +1,
JAX's pairs ``(i, i + 1)``). The last stage's outputs are shared with
every stage by a sum over ``pipeline`` in float32 of the buffers with the
other stages' zeroed, as JAX's masked ``psum`` does.

JAX's loop body must be branchless, so its stages compute the bubble
steps on clamped garbage and drop the result. The port skips them: a
stage runs each microbatch exactly once, and at a bubble step it sends
zeros, so every step is still one matched permute on every rank. The
function is the same.

The backward is written out (:class:`_GPipe`): one process per stage
cannot leave it to autograd, whose graph on a rank does not see what the
other stages do with the activations it sends. The forward keeps each
microbatch's graph through the stage (its remat regions keep only what
they keep); the backward runs the steps in reverse, each one the
transpose of the forward's: the permute by -1 carries a microbatch's
gradient back one stage, the stage's graph gives the gradients of its
input and its layers. The last stage seeds each microbatch with its own
gradient of the shared output (every stage computes the same loss from
it), and the input's gradient, which stage 0 computes, is summed over
``pipeline`` so every stage holds it whole, as GSPMD gives the gradient
of a value replicated over the axis.
"""

from __future__ import annotations

import torch

from kubeflow_tpu_torch.parallel.collectives import psum_, ring_permute
from kubeflow_tpu_torch.parallel.mesh import (
    AXIS_PIPELINE,
    axis_index,
    axis_size,
)
from kubeflow_tpu_torch.weights import _unflatten, flatten


def stage_layer_ranges(n_layers: int, n_stages: int
                       ) -> list[tuple[int, int]]:
    """The contiguous ``[start, stop)`` layer range each pipeline stage
    owns when the stacked L dim shards over ``pipeline``: what a stage
    holds of the weights and of the KV pool, and the check of the
    ``pp_stages`` knob."""
    if n_stages < 1:
        raise ValueError(f"n_stages must be >= 1, got {n_stages}")
    if n_layers % n_stages:
        raise ValueError(
            f"n_layers {n_layers} not divisible by pp_stages {n_stages}")
    per = n_layers // n_stages
    return [(s * per, (s + 1) * per) for s in range(n_stages)]


def _layer_views(paths, leaves) -> list[dict]:
    """One nested dict a layer, of views of the leaves' leading dim."""
    return [_unflatten({p: leaf[i] for p, leaf in zip(paths, leaves)})
            for i in range(leaves[0].shape[0])]


def _stack(layer_fn, layers, h):
    for layer in layers:
        h = layer_fn(layer, h)
    return h


class _Schedule:
    """What :class:`_GPipe` needs beside its tensors."""

    def __init__(self, layer_fn, paths, mesh, n_micro: int):
        self.layer_fn, self.paths, self.mesh = layer_fn, paths, mesh
        self.n_micro = n_micro
        # Whether the caller records a graph (a Function's forward runs
        # with it off).
        self.grad = torch.is_grad_enabled()
        self.n_stages = axis_size(mesh, AXIS_PIPELINE)
        self.stage = axis_index(mesh, AXIS_PIPELINE)

    def permute(self, x, shift: int):
        with torch.no_grad():
            return ring_permute(x, self.mesh, AXIS_PIPELINE, shift=shift)


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sched: _Schedule, x, *leaves):
        n_micro, n_stages, s = sched.n_micro, sched.n_stages, sched.stage
        b = x.shape[0]
        if b % n_micro:
            raise ValueError(
                f"per-shard batch {b} not divisible by n_micro {n_micro}")
        micro = x.detach().reshape(n_micro, b // n_micro, *x.shape[1:])
        record = sched.grad and any(ctx.needs_input_grad[1:])
        ins, outs = {}, {}
        with torch.set_grad_enabled(record):
            params = [leaf.detach().requires_grad_(leaf.requires_grad)
                      for leaf in leaves]
            layers = _layer_views(sched.paths, params)
            state = torch.zeros_like(micro[0])
            for t in range(n_micro + n_stages - 1):
                m = t - s
                if 0 <= m < n_micro:
                    h = (micro[m] if s == 0 else state).detach()
                    h.requires_grad_(record)
                    y = _stack(sched.layer_fn, layers, h)
                    ins[m], outs[m] = h, y
                    send = y.detach()
                else:
                    send = torch.zeros_like(micro[0])
                state = sched.permute(send, 1)
        if s == n_stages - 1:
            buf = torch.stack([outs[m].detach().float()
                               for m in range(n_micro)])
        else:
            buf = torch.zeros(micro.shape, dtype=torch.float32,
                              device=x.device)
        out = psum_(buf, sched.mesh, AXIS_PIPELINE)
        ctx.sched, ctx.ins, ctx.outs, ctx.params = sched, ins, outs, params
        return out.reshape(x.shape).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        sched = ctx.sched
        n_micro, n_stages, s = sched.n_micro, sched.n_stages, sched.stage
        g_micro = g.reshape(n_micro, g.shape[0] // n_micro, *g.shape[1:])
        wants = [p for p in ctx.params if p.requires_grad]
        grads = [None] * len(wants)
        feed = [None] * n_micro
        zero = torch.zeros(g_micro.shape[1:], dtype=g.dtype, device=g.device)
        # The gradient of what this stage received at the end of step t,
        # the input of its step t + 1.
        g_recv = zero
        for t in reversed(range(n_micro + n_stages - 1)):
            g_y = sched.permute(g_recv, -1)
            m = t - s
            g_recv = zero
            if not 0 <= m < n_micro:
                continue
            if s == n_stages - 1:
                g_y = g_y + g_micro[m]
            y = ctx.outs.pop(m)
            got = torch.autograd.grad(y, [ctx.ins[m], *wants],
                                      g_y.to(y.dtype), allow_unused=True)
            for i, gp in enumerate(got[1:]):
                if gp is not None:
                    grads[i] = gp if grads[i] is None else grads[i] + gp
            if s == 0:
                feed[m] = got[0]
            else:
                g_recv = got[0].to(g.dtype)
        g_x = None
        if ctx.needs_input_grad[1]:
            g_x = (torch.stack(feed).float() if s == 0 else
                   torch.zeros(g_micro.shape, dtype=torch.float32,
                               device=g.device))
            g_x = psum_(g_x, sched.mesh, AXIS_PIPELINE).reshape(
                g.shape).to(g.dtype)
        it = iter(grads)
        return (None, g_x, *[next(it) if p.requires_grad else None
                             for p in ctx.params])


def pipeline_apply(layer_fn, stage_params, x, mesh, *, n_micro: int):
    """Run ``x`` [B, ...] through the whole layer stack with the GPipe
    schedule over ``mesh``'s ``pipeline`` axis.

    ``layer_fn(layer, h) -> h`` applies ONE layer (a nested dict of its
    weights); ``stage_params`` is this stage's slice of the stacked tree
    (every leaf ``[L / S, ...]``); ``x`` is this rank's rows, the same on
    every stage, B divisible by ``n_micro``. Returns [B, ...] in x's
    dtype on every stage. Every stage calls it at the same point. At one
    stage it is the plain loop over the layers."""
    flat = flatten(stage_params)
    paths, leaves = list(flat), list(flat.values())
    if axis_size(mesh, AXIS_PIPELINE) == 1:
        return _stack(layer_fn, _layer_views(paths, leaves), x)
    return _GPipe.apply(_Schedule(layer_fn, paths, mesh, n_micro), x,
                        *leaves)
