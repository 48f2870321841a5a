"""The train step, on one device or over a data x FSDP mesh; counterpart of
``kubeflow_tpu/train/trainer.py``.

One step: forward, backward (``torch.autograd.grad``), optimizer update.
The JAX step is one jitted function with donated state; here the step
runs eagerly and updates the parameters and the optimizer slots IN PLACE
under ``torch.no_grad()``, which is what donation buys JAX. The step
returns the same metrics as JAX's: the loss function's (``loss``,
``z_loss``, ``tokens``, MoE's ``router_aux_loss``), ``grad_norm`` (of the
unclipped gradients) and ``step``, as 0-d tensors that stay on the device
until the caller reads them.

The non-gradient state channel: a loss function may return
``metrics["_state_updates"]`` (ResNet's batch-norm running statistics);
after the optimizer step the trainer pops it and applies
``model.update_state``, which writes over whatever the optimizer did to
those leaves (they keep their optimizer slots, so the state's layout is
JAX's). Under gradient accumulation the last microbatch's updates win. A
leaf the loss does not reach (the running statistics, BERT's NSP head)
gets a zero gradient, as ``jax.grad`` gives it.

Over a mesh (one process per device; every axis) GSPMD's collectives are
written out:

- the state is born sharded: each rank keeps its shard of every leaf the
  model's partition rules put on ``fsdp``, ``expert``, ``tensor`` or
  ``pipeline`` (its optimizer slots alike) and the rest whole
  (:class:`StateLayout`; at degree 1 everywhere every leaf is whole);
- each step gathers what ``fsdp`` shards before the forward (once a
  step, not layer by layer) and keeps each leaf's block on the model
  axes (``MODEL_AXES``: an expert range, a tensor block) and its stage's
  layers on ``pipeline``: the forward is Megatron's and GPipe's
  (``models/transformer.py``, ``parallel/pipeline.py``), whose
  collectives carry their own gradients. Each rank runs its rows of the
  batch (the ranks of a model-axis or pipeline group the same rows; the
  ranks of a ``sequence`` group, under context parallelism, each its
  chunk of the rows' tokens), and the loss it differentiates is its term
  of the global loss (the loss functions normalise by the global count,
  ``mesh=``), so gradients are SUMMED over the token axes
  (:func:`token_axes`): reduce-scattered over ``fsdp`` for a leaf fsdp
  shards (then summed over the others), summed over them all otherwise,
  never over ``expert``, ``tensor`` or ``pipeline``;
- the optimizer's reductions span each leaf's shards, and the metrics are
  the global ones.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist
import torch.nn.functional as F

from kubeflow_tpu_torch.device import resolve_device
from kubeflow_tpu_torch.parallel.collectives import (
    global_norm_sq,
    psum_,
    reduce_scatter,
)
from kubeflow_tpu_torch.parallel.mesh import (
    AXIS_PIPELINE,
    BATCH_AXES,
    MESH_AXES,
    MODEL_AXES,
    axis_size,
    is_member,
    mesh_ranks,
)
from kubeflow_tpu_torch.parallel.sharding import (
    ShardedLeaf,
    dim_shards,
    restrict,
    shard,
    spec_axes,
    tree_specs,
    unshard,
)
from kubeflow_tpu_torch.train.optimizers import (
    OptimizerConfig,
    build as build_opt,
    global_norm,
    torch_dtype,
)
from kubeflow_tpu_torch.weights import _unflatten, flatten

# The mesh axes the port trains over: every one (a family refuses what
# it does not run over in its own check_mesh).
TRAIN_AXES = MESH_AXES
# The axes whose shards of a leaf the step keeps: a model axis's block, a
# pipeline stage's layers.
LOCAL_AXES = (*MODEL_AXES, AXIS_PIPELINE)


def _on_model_axes(s) -> bool:
    """Whether a DimShard splits its dim over a model or the pipeline
    axis (the step keeps it local) rather than a batch axis (the step
    gathers it)."""
    return any(a in LOCAL_AXES for a in s.axes)


def token_axes(model) -> tuple[str, ...]:
    """The axes the model's batch spec splits the tokens over (data x
    fsdp, and ``sequence`` under context parallelism): each rank's loss
    is a term over them, so gradients are summed over them."""
    return spec_axes(model.batch_partition_spec(model.config))


@dataclass
class TrainState:
    step: int
    params: dict      # the model's nested parameter dict (master weights)
    opt_state: dict
    # Where each leaf lives over a mesh (None on one device): the state's
    # tensors are this rank's shards.
    layout: "StateLayout | None" = None


class StateLayout:
    """The sharding of a train state on this rank of ``mesh``: each
    parameter's spec from the model's partition rules, keeping only the
    training axes of degree above 1 (the others are 1 here, and an axis
    of one shard holds the whole leaf: at fsdp, expert and tensor 1 the
    state is whole and the step is plain data parallelism), and the same
    spec for its optimizer slots of the same rank (JAX's rank fallback
    replicates the rest, such as adafactor's factored moments).

    A step gathers what ``fsdp`` shards and leaves the dims of the model
    axes local: the forward runs Megatron's column and row split and the
    rank's experts on this rank's block (``models/transformer.py``). An
    expert leaf may be sharded on three dims at once, ``[L, E/ep,
    D/fsdp, F/tp]``.

    ``shapes``: each parameter's whole shape, in the state's leaf order;
    ``tokens``: the axes the batch's tokens are split over
    (:func:`token_axes`).

    A rank outside a mesh that holds only some ranks (an elastic run's
    mesh after a shrink) may build its layout too: the specs and the
    checks are the same, it holds no shard (``member`` False) and only
    :mod:`kubeflow_tpu_torch.parallel.reshard` reads it."""

    def __init__(self, mesh, rules, shapes: dict[str, tuple],
                 tokens: tuple[str, ...] = BATCH_AXES):
        self.mesh = mesh
        self.tokens = tokens
        self.member = is_member(mesh)
        self.shapes = {k: tuple(s) for k, s in shapes.items()}
        axes = tuple(a for a in TRAIN_AXES if axis_size(mesh, a) > 1)
        self.specs = {k: restrict(spec, axes)
                      for k, spec in tree_specs(self.shapes, rules).items()}
        # What the step gathers: the batch axes' part of each spec.
        self._gathered = {k: restrict(spec, BATCH_AXES)
                          for k, spec in self.specs.items()}
        self._leaves: dict[str, ShardedLeaf] = {}
        # Outside the mesh the checks run on the mesh's first rank.
        at = None if self.member else mesh_ranks(mesh)[0]
        for k, spec in self.specs.items():
            shards = dim_shards(self.shapes[k], spec, mesh, at)
            if sum(1 for s in shards if not _on_model_axes(s)) > 1:
                raise ValueError(f"{k}: a leaf sharded along more than one "
                                 "dim by the batch axes is not yet ported")
            for s in shards:
                if _on_model_axes(s) and s.size % s.n:
                    raise ValueError(
                        f"{k}: dim {s.dim} of {self.shapes[k]} is not "
                        f"divisible by the {'/'.join(s.axes)} degree {s.n}")
            if shards and self.member:
                self._leaves[k] = ShardedLeaf(self.shapes[k], tuple(shards),
                                              mesh)

    def leaf(self, key: str) -> ShardedLeaf | None:
        return self._leaves.get(key)

    def _slot_spec(self, key: str, t: torch.Tensor) -> tuple:
        return self.spec_of(key, t.ndim)

    def spec_of(self, key: str, ndim: int) -> tuple:
        """The spec of a leaf of ``ndim`` dims under parameter ``key``: the
        parameter's, or replicated where it names more dims (JAX's rank
        fallback, adafactor's factored moments)."""
        spec = self.specs[key]
        return () if len(spec) > ndim else spec

    # The state, whole <-> this rank's shards.

    def _map_opt(self, opt_state: dict, fn) -> dict:
        return {slot: (value if slot == "count" else
                       {k: fn(k, t) for k, t in value.items()})
                for slot, value in opt_state.items()}

    def shard_state(self, state: TrainState) -> TrainState:
        """This rank's shard of a whole state (no collective)."""
        params = {k: shard(p, self.specs[k], self.mesh)
                  for k, p in flatten(state.params).items()}
        opt = self._map_opt(state.opt_state, lambda k, t: shard(
            t, self._slot_spec(k, t), self.mesh))
        return TrainState(state.step, _unflatten(params), opt, self)

    def gather_state(self, state: TrainState, dst: int = 0
                     ) -> TrainState | None:
        """The whole state on rank ``dst`` from every rank's shards, None
        on the others (a collective: every rank calls it at the same
        point). One sharded leaf at a time is gathered whole and moved to
        the host, so no device holds more than its shards and one whole
        leaf; the leaves every rank holds whole stay where they are."""
        keep = dist.get_rank() == dst

        def host(k, t, spec):
            if k not in self._leaves or not spec:
                return t if keep else None
            t = unshard(t, spec, self.mesh, self.shapes[k])
            return t.cpu() if keep else None

        params = {k: host(k, p, self.specs[k])
                  for k, p in flatten(state.params).items()}
        opt = self._map_opt(state.opt_state,
                            lambda k, t: host(k, t, self._slot_spec(k, t)))
        if not keep:
            return None
        return TrainState(state.step, _unflatten(params), opt, None)

    # The step's collectives.

    def _batch_shard(self, key: str):
        """The DimShard of the dim the batch axes shard, or None."""
        leaf = self._leaves.get(key)
        return None if leaf is None else next(
            (s for s in leaf.shards if not _on_model_axes(s)), None)

    def gather_params(self, flat: dict) -> dict:
        """Every leaf whole along what fsdp shards (all-gathered), its
        block on the model axes as it is; the others as they are."""
        return {k: unshard(p, self._gathered[k], self.mesh, self.shapes[k])
                if self._batch_shard(k) else p for k, p in flat.items()}

    def reduce_grads(self, grads: dict) -> dict:
        """Gradients of each rank's loss term (whole along fsdp, its block
        on the model axes, its layers on ``pipeline``) -> this rank's
        shard of their sum over the token axes: a leaf fsdp shards is
        reduce-scattered over its axes, then summed over the other token
        axes; the other leaves' are summed over every token axis in one
        flat buffer. The ranks of the model axes and of ``pipeline`` hold
        the same rows, and each holds the whole gradient of a leaf it
        replicates, so nothing is summed over ``expert``, ``tensor`` or
        ``pipeline``."""
        out, whole = {}, []
        for k, g in grads.items():
            s = self._batch_shard(k)
            if s is None:
                whole.append(k)
                continue
            pad = s.n * s.chunk - s.size
            if pad:
                g = F.pad(g, [0, 0] * (g.ndim - 1 - s.dim) + [0, pad])
            g = reduce_scatter(g, self.mesh, s.axes, dim=s.dim)
            rest = tuple(a for a in self.tokens if a not in s.axes)
            if rest:
                psum_(g, self.mesh, rest)
            out[k] = g
        for dtype in dict.fromkeys(grads[k].dtype for k in whole):
            keys = [k for k in whole if grads[k].dtype == dtype]
            flat = psum_(torch.cat([grads[k].reshape(-1) for k in keys]),
                         self.mesh, self.tokens)
            for k, piece in zip(keys, flat.split(
                    [grads[k].numel() for k in keys])):
                out[k] = piece.view_as(grads[k])
        return {k: out[k] for k in grads}

    def global_norm(self, tensors: dict) -> torch.Tensor:
        """optax.global_norm of the whole tree from this rank's shards:
        each sharded leaf's squares summed over its shards (padding holds
        zeros; fsdp, expert and tensor shards each once), each whole
        leaf's counted once."""
        whole, sharded = [], {}
        for k, t in tensors.items():
            leaf = self.leaf(k)
            if leaf is None:
                whole.append(t)
            else:
                sharded.setdefault(leaf.axes, []).append(t)
        total = global_norm_sq(whole) if whole else 0.0
        for axes, part in sharded.items():
            total = total + global_norm_sq(part, self.mesh, axes)
        return torch.sqrt(total)


def check_mesh(model, mesh) -> None:
    """Raise what the model's own ``check_mesh`` raises: an axis its
    family does not yet train over, degrees that do not divide its
    shapes."""
    if model.check_mesh is not None:
        model.check_mesh(model.config, mesh)


def init_state(generator: torch.Generator, model, opt_cfg: OptimizerConfig,
               mesh=None, *, device: str | torch.device = "cuda"
               ) -> TrainState:
    """Float32 master parameters from ``generator`` and the optimizer's
    zero state, on ``device``. Over ``mesh`` every rank draws the same
    whole parameters (the same generator seed) and keeps its shards."""
    params = model.init(model.config, generator=generator,
                        device=resolve_device(device),
                        param_dtype=torch.float32)
    state = TrainState(step=0, params=params,
                       opt_state=build_opt(opt_cfg).init(flatten(params)))
    if mesh is None:
        return state
    check_mesh(model, mesh)
    layout = StateLayout(mesh, model.partition_rules(model.config),
                         {k: p.shape for k, p in flatten(params).items()},
                         token_axes(model))
    return layout.shard_state(state)


def build_train_step(model, opt_cfg: OptimizerConfig, mesh=None, *,
                     accum_steps: int = 1):
    """Returns ``step_fn(state, batch) -> (state, metrics)``; ``state`` is
    updated in place and returned.

    ``accum_steps > 1``: batch leaves carry a leading [accum_steps, ...]
    axis (``data.stack_microbatches``); the step runs the microbatches in
    turn, accumulating the MEAN gradient in the gradient dtype
    (``opt_cfg.grad_dtype`` or the parameter dtype) before ONE optimizer
    update, and averages the scalar metrics over the microbatches. Over
    ``mesh`` (the state from :func:`init_state` with the same mesh) the
    batch is this rank's rows, and the accumulated gradient is reduced
    once, after the last microbatch."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    if mesh is not None:
        check_mesh(model, mesh)
    opt = build_opt(opt_cfg)
    grad_dtype = torch_dtype(opt_cfg.grad_dtype) if opt_cfg.grad_dtype \
        else None

    def grads_of(flat: dict, batch: dict):
        # Leaves of the autograd graph: the master weights themselves, or
        # a view of them in grad_dtype (JAX differentiates p.astype(gdt)).
        leaves = {k: (p.detach().to(grad_dtype) if grad_dtype
                      and p.is_floating_point() else p.detach())
                  .requires_grad_(True) for k, p in flat.items()}
        loss, metrics = model.loss_fn(_unflatten(leaves), batch,
                                      model.config, mesh=mesh)
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(leaves.items(), grads)}
        updates = metrics.pop("_state_updates", None)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return metrics, grads, updates

    def whole_params(state: TrainState) -> dict:
        if (state.layout is None) != (mesh is None):
            raise ValueError("the state's mesh and the step's differ; "
                             "build both with the same mesh")
        flat = flatten(state.params)
        return flat if state.layout is None else \
            state.layout.gather_params(flat)

    def apply_update(state: TrainState, metrics: dict, grads: dict,
                     updates=None):
        layout = state.layout
        if layout is not None:
            grads = layout.reduce_grads(grads)
        g_norm = (global_norm(grads.values()) if layout is None
                  else layout.global_norm(grads))
        metrics["grad_norm"] = g_norm
        metrics["step"] = torch.tensor(state.step)
        with torch.no_grad():
            opt.update(grads, state.opt_state, flatten(state.params),
                       layout=layout, g_norm=g_norm)
        if updates is not None and model.update_state is not None:
            model.update_state(state.params, updates)
        state.step += 1
        return state, metrics

    def step_fn(state: TrainState, batch: dict):
        return apply_update(state, *grads_of(whole_params(state), batch))

    def accum_step_fn(state: TrainState, batch: dict):
        flat = whole_params(state)
        acc, sums = None, {}
        for i in range(accum_steps):
            # The last microbatch's state updates win, as in JAX.
            metrics, grads, updates = grads_of(
                flat, {k: v[i] for k, v in batch.items()})
            # Divide per microbatch: the accumulator holds a running MEAN,
            # so a low-precision gradient dtype never sees a k-times sum.
            if acc is None:
                acc = {k: torch.zeros_like(g) for k, g in grads.items()}
            for k, g in grads.items():
                acc[k] += g.to(acc[k].dtype) / accum_steps
            for k, v in metrics.items():
                sums[k] = sums.get(k, 0.0) + v
        return apply_update(state, {k: v / accum_steps
                                    for k, v in sums.items()}, acc, updates)

    return accum_step_fn if accum_steps > 1 else step_fn
