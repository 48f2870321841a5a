"""Named-rule sharding of flat parameter dicts; counterpart of
``kubeflow_tpu/parallel/sharding.py``.

A spec is a tuple with one entry per leading dim of a leaf, standing for
JAX's ``PartitionSpec``: ``None`` (replicated), an axis name, or a tuple
of axis names taken together (the first major); ``()`` replicates the
whole leaf. Rules match the ``/``-joined path of a leaf by regex, first
match wins, and a rule whose spec names more dims than the leaf has falls
back to the default, as in JAX (adafactor's factored moments live under
their parameter's path).

Where GSPMD shards a dim the degree does not divide, each shard holds
``ceil(size / degree)`` rows and the last ones are padding; :func:`shard`
pads with zeros and :func:`unshard` drops the padding. A leaf may be
sharded along several dims at once (``attn/wq``'s ``P(None, fsdp,
tensor)`` under fsdp x tensor; an expert leaf's ``P(None, expert, fsdp,
tensor)``: ``[L, E/ep, D/fsdp, F/tp]``).

:func:`split_tensor` and :func:`merge_tensor` cut a whole tree into its
tensor shards in one process and join them back: the layout of a
tensor-parallel serving replica, whose shards one process drives (its
mesh has no ``expert`` axis, so an expert leaf keeps every expert and is
cut on its ``d_ff`` dim).
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from kubeflow_tpu_torch.parallel.collectives import (
    all_gather,
    psum_,
    reduce_from_tensor,
)
from kubeflow_tpu_torch.parallel.mesh import (
    AXIS_DATA,
    AXIS_FSDP,
    AXIS_SEQUENCE,
    AXIS_TENSOR,
    PipelineStages,
    TensorShards,
    axis_index,
    axis_size,
    tensor_mesh,
)
from kubeflow_tpu_torch.weights import _unflatten, flatten


def P(*entries) -> tuple:
    """A spec, written as JAX writes ``PartitionSpec(...)``."""
    return tuple(entries)


@dataclass(frozen=True)
class PartitionRule:
    """Map leaf paths matching ``pattern`` to ``spec``."""

    pattern: str
    spec: tuple

    def matches(self, path: str) -> bool:
        return re.search(self.pattern, path) is not None


def path_str(key_path) -> str:
    """A key path (dict keys, list indices) as 'a/b/0/c'."""
    return "/".join(str(k) for k in key_path)


def spec_for_path(path: str, rules: list[PartitionRule],
                  default: tuple = ()) -> tuple:
    for rule in rules:
        if rule.matches(path):
            return rule.spec
    return default


def tree_specs(flat: dict, rules: list[PartitionRule],
               default: tuple = ()) -> dict[str, tuple]:
    """{path: spec} for a flat ``{path: tensor or shape}`` dict, with
    JAX's fallback to ``default`` where a rule names more dims than the
    leaf has."""

    def ndim(leaf):
        return leaf.ndim if isinstance(leaf, torch.Tensor) else len(leaf)

    out = {}
    for path, leaf in flat.items():
        spec = spec_for_path(path, rules, default)
        out[path] = default if len(spec) > ndim(leaf) else spec
    return out


def batch_spec(sequence_sharded: bool = False) -> tuple:
    """Spec for [batch, seq, ...] activations: batch over data x fsdp, the
    sequence over the sequence axis under context parallelism."""
    if sequence_sharded:
        return P((AXIS_DATA, AXIS_FSDP), AXIS_SEQUENCE)
    return P((AXIS_DATA, AXIS_FSDP))


def _entry_axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_axes(spec: tuple) -> tuple[str, ...]:
    """Every axis ``spec`` names, in dim order."""
    return tuple(a for entry in spec for a in _entry_axes(entry))


def restrict(spec: tuple, axes: tuple[str, ...]) -> tuple:
    """``spec`` with every axis outside ``axes`` dropped (a dim left with
    none is replicated)."""
    out = []
    for entry in spec:
        kept = tuple(a for a in _entry_axes(entry) if a in axes)
        out.append(None if not kept else kept[0] if len(kept) == 1
                   else kept)
    return tuple(out)


@dataclass(frozen=True)
class DimShard:
    """One sharded dim of a leaf on this rank: the dim, its axes, the
    full size, the shard count ``n``, this rank's ``index`` and rows a
    shard (``chunk``, the last shard padded)."""

    dim: int
    axes: tuple[str, ...]
    size: int
    n: int
    index: int

    @property
    def chunk(self) -> int:
        return -(-self.size // self.n)

    @property
    def valid(self) -> int:
        """Rows of this rank's shard that are not padding."""
        return max(0, min(self.chunk, self.size - self.index * self.chunk))


def dim_shards(shape, spec: tuple, mesh) -> list[DimShard]:
    """The sharded dims of a leaf of ``shape`` under ``spec`` (every dim
    whose entry names an axis, at any degree)."""
    out = []
    for dim, entry in enumerate(spec):
        axes = _entry_axes(entry)
        if axes:
            out.append(DimShard(dim, axes, int(shape[dim]),
                                axis_size(mesh, axes),
                                axis_index(mesh, axes)))
    return out


def shard_dim(x: torch.Tensor, s: DimShard, fill: float = 0.0):
    """This rank's block of full ``x`` along ``s.dim``, padded with
    ``fill`` to ``s.chunk`` rows."""
    block = x.narrow(s.dim, s.index * s.chunk, s.valid) if s.valid else \
        x.narrow(s.dim, 0, 0)
    pad = s.chunk - s.valid
    if not pad:
        return block.clone()
    widths = [0, 0] * (x.ndim - 1 - s.dim) + [0, pad]
    return F.pad(block, widths, value=fill)


def unshard_dim(local: torch.Tensor, s: DimShard, mesh):
    """The full leaf along ``s.dim`` from every rank's block (a collective
    over ``s.axes``), padding dropped."""
    return all_gather(local, mesh, s.axes, dim=s.dim).narrow(s.dim, 0, s.size)


def shard(x: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's shard of the full leaf ``x`` under ``spec``."""
    for s in dim_shards(x.shape, spec, mesh):
        x = shard_dim(x, s)
    return x


def unshard(local: torch.Tensor, spec: tuple, mesh, shape) -> torch.Tensor:
    """The full leaf of ``shape`` from every rank's shard under ``spec``
    (a collective over the spec's axes): the inverse of :func:`shard`."""
    for s in reversed(dim_shards(shape, spec, mesh)):
        local = unshard_dim(local, s, mesh)
    return local


def numel(shape) -> int:
    return math.prod(int(n) for n in shape)


@dataclass(frozen=True)
class ShardedLeaf:
    """A leaf sharded along one dim or more (fsdp on one, tensor on
    another), as an optimizer sees it on this rank: the whole leaf's
    ``shape``, each sharded dim's :class:`DimShard` and the mesh, with the
    reductions that span the shards."""

    shape: tuple[int, ...]
    shards: tuple[DimShard, ...]
    mesh: object

    @property
    def numel(self) -> int:
        return numel(self.shape)

    @property
    def axes(self) -> tuple[str, ...]:
        """Every axis the leaf is sharded over, in dim order."""
        return tuple(a for s in self.shards for a in s.axes)

    def shard_of(self, dim: int) -> DimShard | None:
        return next((s for s in self.shards if s.dim == dim), None)

    def zero_pad(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` (this rank's shard) with its padding rows zeroed."""
        for s in self.shards:
            if s.valid != s.chunk:
                rows = torch.arange(s.chunk, device=x.device) < s.valid
                x = x * rows.reshape([-1] + [1] * (x.ndim - 1 - s.dim)).to(
                    x.dtype)
        return x

    def mean(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The whole leaf's mean over ``dim`` from this rank's ``x``: over
        a sharded dim the shards' sums are added up (padding must hold
        zeros), and along every other sharded dim each rank's rows of the
        result are gathered, padding dropped."""
        s = self.shard_of(dim)
        out = x.mean(dim=dim) if s is None else \
            psum_(x.sum(dim=dim), self.mesh, s.axes) / s.size
        for t in self.shards:
            if t.dim != dim:
                d = t.dim - (t.dim > dim)
                out = all_gather(out, self.mesh, t.axes, dim=d).narrow(
                    d, 0, t.size)
        return out

    def mean_all(self, x: torch.Tensor) -> torch.Tensor:
        """The mean of every element of the leaf (padding must hold
        zeros)."""
        total = torch.sum(x)
        for s in self.shards:
            total = psum_(total, self.mesh, s.axes)
        return total / self.numel

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a whole tensor broadcast against the leaf
        (size 1 along a sharded dim broadcasts as it is); padding rows
        hold 1."""
        for s in self.shards:
            if x.shape[s.dim] != 1:
                x = shard_dim(x, s, fill=1.0)
        return x


def tensor_dim(spec: tuple) -> int | None:
    """The dim a spec puts on the ``tensor`` axis, or None."""
    return next((d for d, e in enumerate(spec)
                 if AXIS_TENSOR in _entry_axes(e)), None)


def vocab_rows(table: torch.Tensor, tokens: torch.Tensor, index: int):
    """The rows of ``tokens`` in block ``index`` of a table split over the
    vocabulary (``table`` is that block, on its device): a token the block
    does not hold gets a zero row, so the blocks' rows summed are the
    whole table's lookup (one nonzero term a token)."""
    rows = table.shape[0]
    local = tokens.to(table.device).long() - index * rows
    held = (local >= 0) & (local < rows)
    return torch.where(held[..., None], table[local.clamp(0, rows - 1)],
                       0.0)


def vocab_lookup(table: torch.Tensor, tokens: torch.Tensor, mesh):
    """The rows of ``tokens``: over ``mesh``'s tensor axis ``table`` is
    this rank's block of the vocabulary (:func:`vocab_rows`), and the
    ranks' rows are summed; without a tensor split, the plain gather."""
    if tensor_mesh(mesh) is None:
        return table[tokens.long()]
    return reduce_from_tensor(
        vocab_rows(table, tokens, axis_index(mesh, AXIS_TENSOR)), mesh)


def split_kv_heads(side, devices) -> TensorShards:
    """One side of a KV store (a pool, dense rows or a scratch cache; an
    fp tensor ``[..., H, hd]`` or ``{"q": int8 [..., H, hd], "scale":
    [..., H]}``) cut over its KV heads into one contiguous tensor a shard,
    shard ``i`` on ``devices[i]``: each shard's own store, as the paged
    kernel takes it."""
    tp = len(devices)

    def cut(arr, dim):
        if arr.shape[dim] % tp:
            raise ValueError(f"{arr.shape[dim]} kv heads not divisible by "
                             f"{tp} tensor shards")
        return [part.contiguous().to(dev) for part, dev in
                zip(torch.chunk(arr, tp, dim=dim), devices)]

    if isinstance(side, dict):
        return TensorShards(
            {"q": q, "scale": s} for q, s in
            zip(cut(side["q"], side["q"].ndim - 2),
                cut(side["scale"], side["scale"].ndim - 1)))
    return TensorShards(cut(side, side.ndim - 2))


def split_tensor(tree, rules: list[PartitionRule], tp: int) -> list:
    """A nested parameter tree cut into its ``tp`` tensor shards by the
    rules' ``tensor`` entries (Megatron's column and row split, the vocab
    split of the embedding and the head): shard ``i`` holds the ``i``-th
    contiguous block of every such dim, as its own contiguous tensor on
    the leaf's device, and every other leaf as it is. Each split dim must
    divide by ``tp``."""
    flat = flatten(tree)
    specs = tree_specs(flat, rules)
    shards: list[dict] = [{} for _ in range(tp)]
    for path, leaf in flat.items():
        dim = tensor_dim(specs[path]) if tp > 1 else None
        if dim is None:
            for shard_tree in shards:
                shard_tree[path] = leaf
            continue
        if leaf.shape[dim] % tp:
            raise ValueError(f"{path}: dim {dim} of {tuple(leaf.shape)} is "
                             f"not divisible by {tp} tensor shards")
        for i, part in enumerate(torch.chunk(leaf, tp, dim=dim)):
            shards[i][path] = part.contiguous()
    return [_unflatten(t) for t in shards]


def merge_tensor(shards: list, rules: list[PartitionRule]):
    """The inverse of :func:`split_tensor`: the whole tree on shard 0's
    devices."""
    flats = [flatten(t) for t in shards]
    specs = tree_specs(flats[0], rules)
    out = {}
    for path, leaf in flats[0].items():
        dim = tensor_dim(specs[path]) if len(flats) > 1 else None
        out[path] = leaf if dim is None else torch.cat(
            [f[path].to(leaf.device) for f in flats], dim=dim)
    return _unflatten(out)


def merge_replica(params, rules: list[PartitionRule]):
    """The whole tree of a serving replica's parameters (a tree, its
    ``TensorShards`` or its ``PipelineStages``; ``weights.replica_shards``)
    on stage 0's shard 0's devices: each stage's shards joined
    (:func:`merge_tensor`), the stages' ``layers/`` leaves one after
    another."""
    stages = list(params) if isinstance(params, PipelineStages) else [params]
    wholes = [flatten(merge_tensor(st, rules) if isinstance(st, TensorShards)
                      else st) for st in stages]
    return _unflatten({
        path: torch.cat([w[path].to(leaf.device) for w in wholes])
        if len(wholes) > 1 and path.startswith("layers/") else leaf
        for path, leaf in wholes[0].items()})
