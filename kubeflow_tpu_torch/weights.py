"""Parameter trees and train states handed across as numpy arrays.

The JAX package's parameter pytree of any family (the ``init`` of
``kubeflow_tpu/models/{transformer,bert,resnet}.py``), with every leaf
converted to a numpy array, becomes the port's parameter tree with the
same nesting: dicts, and lists where JAX has them (ResNet's ``stages``).
Leaves are named with the ``a/b/c`` path convention of
``kubeflow_tpu/parallel/sharding.py:path_str``, list indices included
(``stages/0/1/conv1``), copied here so names match without importing the
JAX package. Each leaf is stored in the dtype JAX reads it in, as the
model's config says (its ``leaf_dtype``).

A whole train state goes across as a flat ``{path: numpy array}`` dict
keyed by the JAX ``TrainState``'s paths (``step``, ``params/...``,
``opt_state/...`` through optax's chain): :func:`state_from_numpy` and
:func:`state_to_numpy`, which the checkpoint files use too.
"""

from __future__ import annotations

import numpy as np
import torch

from kubeflow_tpu_torch.device import resolve_device
from kubeflow_tpu_torch.train.optimizers import (
    OptimizerConfig,
    _factored_dims,
    torch_dtype,
)


def path_str(key_path) -> str:
    """Render a key path (a sequence of dict keys or indices) as 'a/b/c'."""
    return "/".join(str(k) for k in key_path)


def flatten(tree, prefix=()) -> dict[str, object]:
    """{'a/b/c': leaf} over nested dicts and lists (a list's items by
    their index)."""
    if isinstance(tree, (dict, list)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        out = {}
        for k, v in items:
            out.update(flatten(v, (*prefix, k)))
        return out
    return {path_str(prefix): tree}


def _listify(node):
    """Nodes whose keys are exactly "0".."n-1" become lists, as they were
    before :func:`flatten`."""
    if not isinstance(node, dict):
        return node
    node = {k: _listify(v) for k, v in node.items()}
    if node and set(node) == {str(i) for i in range(len(node))}:
        return [node[str(i)] for i in range(len(node))]
    return node


def _unflatten(flat: dict[str, object]):
    """The inverse of :func:`flatten`."""
    tree: dict = {}
    for path, leaf in flat.items():
        node = tree
        *parents, last = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return _listify(tree)


def params_from_numpy(tree, model, device: str | torch.device = "cuda",
                      dtype: torch.dtype | None = None):
    """Numpy parameter tree → the port's parameter tree on ``device``.
    ``model`` is the model's spec (``registry.get_model``) or its config,
    of any family.

    By default the leaves JAX casts to ``cfg.dtype`` at every use land in
    ``cfg.dtype`` (storing the cast once computes the same thing for
    serving) and the leaves it reads in float32 stay float32 (the config's
    ``leaf_dtype``). ``dtype=torch.float32`` keeps every leaf in
    float32: training's master weights, as the JAX trainer holds them."""
    cfg = getattr(model, "config", model)
    dev = resolve_device(device)
    flat = {}
    for path, leaf in flatten(tree).items():
        arr = np.array(leaf, dtype=np.float32)  # a writable copy
        flat[path] = torch.from_numpy(arr).to(
            device=dev, dtype=cfg.leaf_dtype(path, dtype))
    return _unflatten(flat)


def tensor_shards(tree, model, tp: int):
    """A parameter tree (the port's tensors, or numpy arrays in JAX's
    layout) as the ``tp`` shards of a tensor-parallel serving replica
    (a ``TensorShards`` of trees): cut by the transformer's partition
    rules (``parallel.sharding.split_tensor``: Megatron's column and row
    split, the vocabulary split of the embedding and the head, a mixture
    of experts' gate/up/down on their ``d_ff`` dim with every expert on
    each shard). Tensor
    leaves keep their device and dtype; numpy leaves become host tensors
    in the dtype JAX reads them in, as :func:`params_from_numpy` stores
    them. The serving replica, its live weight pushes and the tests all
    cut a tree through here."""
    from kubeflow_tpu_torch.models.transformer import partition_rules
    from kubeflow_tpu_torch.parallel.mesh import TensorShards
    from kubeflow_tpu_torch.parallel.sharding import split_tensor

    cfg = getattr(model, "config", model)

    def tensor(path, leaf):
        if isinstance(leaf, torch.Tensor):
            return leaf
        arr = np.array(leaf, dtype=np.float32)  # a writable copy
        return torch.from_numpy(arr).to(cfg.leaf_dtype(path))

    whole = _unflatten({p: tensor(p, leaf)
                        for p, leaf in flatten(tree).items()})
    return TensorShards(split_tensor(whole, partition_rules(cfg), tp))


def replica_shards(tree, model, tp: int, pp: int = 1):
    """A parameter tree as a serving replica of ``pp`` pipeline stages of
    ``tp`` tensor shards holds it: stage ``st`` keeps its range
    (``parallel.pipeline.stage_layer_ranges``) of every stacked
    ``layers/`` leaf, as tensors of their own, and every other leaf whole
    (JAX replicates them over ``pipeline``), cut into its
    :func:`tensor_shards` when ``tp > 1``. A ``PipelineStages`` of the
    stages when ``pp > 1``; the tree or its ``TensorShards`` otherwise.
    Leaves keep their device."""
    from kubeflow_tpu_torch.parallel.mesh import PipelineStages
    from kubeflow_tpu_torch.parallel.pipeline import stage_layer_ranges

    cfg = getattr(model, "config", model)
    if pp == 1:
        return tensor_shards(tree, model, tp) if tp > 1 else tree
    flat = flatten(tree)
    stages = []
    for start, stop in stage_layer_ranges(cfg.n_layers, pp):
        part = _unflatten({p: leaf[start:stop].clone()
                           if p.startswith("layers/") else leaf
                           for p, leaf in flat.items()})
        stages.append(tensor_shards(part, model, tp) if tp > 1 else part)
    return PipelineStages(stages)


def params_to_numpy(params):
    """The port's parameter tree → a nested tree of float32 numpy arrays
    (the inverse of :func:`params_from_numpy`), so tests compare trees."""
    # np.array copies: a float32 CPU tensor's .numpy() shares its memory,
    # and the trainer updates parameters in place.
    return _unflatten({path: np.array(leaf.detach().float().cpu())
                       for path, leaf in flatten(params).items()})


def _opt_paths(opt_cfg: OptimizerConfig) -> tuple[str, str]:
    """(the optimizer's own state, the schedule's count) in the JAX
    ``opt_state`` of ``kubeflow_tpu/train/optimizers.py:build``: optax's
    chain puts clip_by_global_norm first when clipping, and the schedule's
    state sits after adamw's decay (adamw, adafactor) or right after the
    moments (adam, sgd)."""
    if opt_cfg.name not in ("adamw", "adam", "sgd", "adafactor"):
        raise ValueError(f"unknown optimizer {opt_cfg.name!r}")
    pre = "opt_state/1/" if opt_cfg.grad_clip_norm else "opt_state/"
    sched = 2 if opt_cfg.name in ("adamw", "adafactor") else 1
    return pre + "0", f"{pre}{sched}/count"


def _slots(opt_cfg: OptimizerConfig) -> tuple[str, ...]:
    return {"adamw": ("mu", "nu"), "adam": ("mu", "nu"), "sgd": ("trace",),
            "adafactor": ("v_row", "v_col", "v")}[opt_cfg.name]


def _state_paths(param_paths, opt_cfg: OptimizerConfig) -> set[str]:
    """Every path of the JAX ``TrainState`` for these parameters."""
    own, sched = _opt_paths(opt_cfg)
    paths = {"step", sched} | {f"params/{k}" for k in param_paths}
    if opt_cfg.name != "sgd":
        paths.add(f"{own}/count")
    return paths | {f"{own}/{slot}/{k}" for slot in _slots(opt_cfg)
                    for k in param_paths}


def _numpy(t) -> np.ndarray:
    """A host copy (bf16 widened exactly to float32; numpy has no bf16)."""
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    dtype = torch.float32 if t.dtype == torch.bfloat16 else t.dtype
    return t.detach().to("cpu", dtype, copy=True).numpy()


def state_to_numpy(state, opt_cfg: OptimizerConfig) -> dict[str, np.ndarray]:
    """The port's train state → the flat numpy dict of the JAX
    ``TrainState`` that ``opt_cfg`` builds (host copies; bf16 slots as
    float32): the inverse of :func:`state_from_numpy`. adafactor's unused
    slot of each leaf is the (1,) zeros optax keeps there."""
    own, sched = _opt_paths(opt_cfg)
    opt = state.opt_state
    count = np.asarray(opt["count"], np.int32)
    flat = {"step": np.asarray(state.step, np.int32), sched: count}
    params = flatten(state.params)
    for path, p in params.items():
        flat[f"params/{path}"] = _numpy(p)
    if opt_cfg.name != "sgd":
        flat[f"{own}/count"] = count
    for slot in _slots(opt_cfg):
        for path in params:
            leaf = opt[slot].get(path)
            flat[f"{own}/{slot}/{path}"] = (
                np.zeros((1,), np.float32) if leaf is None else _numpy(leaf))
    return flat


def state_from_numpy(flat: dict, opt_cfg: OptimizerConfig,
                     device: str | torch.device = "cuda", *, like=None):
    """A JAX ``TrainState`` as a flat ``{path: numpy array}`` dict (its
    leaves by ``path_str`` of their key paths) → the port's
    :class:`~kubeflow_tpu_torch.train.trainer.TrainState` on ``device``,
    for an optimizer built from ``opt_cfg``: the step, the float32 master
    parameters and every slot (adam/adamw mu and nu, mu in
    ``opt_cfg.mu_dtype``; adafactor's factored row and column moments or
    its unfactored moment; sgd's trace) and the count. Raises unless the
    paths are exactly those of that optimizer's state.

    ``like`` (a port ``TrainState``) fixes the order of the leaves, which
    is the order the optimizer sums the gradient norm in, so a restored
    state continues bit for bit, and its shapes, which must match."""
    from kubeflow_tpu_torch.train.trainer import TrainState

    dev = resolve_device(device)
    own, sched = _opt_paths(opt_cfg)
    param_paths = [p[len("params/"):] for p in flat
                   if p.startswith("params/")]
    if like is not None:
        shapes = {k: tuple(p.shape) for k, p in flatten(like.params).items()}
        got = {k: tuple(np.shape(flat[f"params/{k}"])) for k in param_paths}
        if got != shapes:
            diff = sorted(set(got.items()) ^ set(shapes.items()))
            raise ValueError(f"parameter shapes differ from the template's: "
                             f"{diff[:4]}")
        param_paths = list(shapes)
    expected = _state_paths(param_paths, opt_cfg)
    if expected != set(flat):
        raise ValueError(
            f"not the state of optimizer {opt_cfg.name!r} (clip "
            f"{opt_cfg.grad_clip_norm}): missing "
            f"{sorted(expected - set(flat))[:4]}, unexpected "
            f"{sorted(set(flat) - expected)[:4]}")
    if opt_cfg.name != "sgd" and int(flat[f"{own}/count"]) != \
            int(flat[sched]):
        raise ValueError("the optimizer's and the schedule's counts differ")

    def tensor(path, dtype=torch.float32):
        arr = np.array(flat[path], dtype=np.float32)  # a writable copy
        return torch.from_numpy(arr).to(device=dev, dtype=dtype)

    params = {k: tensor(f"params/{k}") for k in param_paths}
    opt: dict = {"count": int(flat[sched])}
    if opt_cfg.name in ("adamw", "adam"):
        mu_dtype = (torch_dtype(opt_cfg.mu_dtype) if opt_cfg.mu_dtype
                    else torch.float32)
        opt["mu"] = {k: tensor(f"{own}/mu/{k}", mu_dtype) for k in params}
        opt["nu"] = {k: tensor(f"{own}/nu/{k}") for k in params}
    elif opt_cfg.name == "sgd":
        opt["trace"] = {k: tensor(f"{own}/trace/{k}") for k in params}
    else:
        opt["v_row"], opt["v_col"], opt["v"] = {}, {}, {}
        for k, p in params.items():
            slots = ("v",) if _factored_dims(p.shape) is None \
                else ("v_row", "v_col")
            for slot in slots:
                opt[slot][k] = tensor(f"{own}/{slot}/{k}")
    return TrainState(step=int(flat["step"]), params=_unflatten(params),
                      opt_state=opt)
