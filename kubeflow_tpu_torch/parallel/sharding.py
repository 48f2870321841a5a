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
pads with zeros and :func:`unshard` drops the padding.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from kubeflow_tpu_torch.parallel.collectives import all_gather, psum_
from kubeflow_tpu_torch.parallel.mesh import (
    AXIS_DATA,
    AXIS_FSDP,
    AXIS_SEQUENCE,
    axis_index,
    axis_size,
)


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
    """A leaf sharded along one dim, as an optimizer sees it on this rank:
    the whole leaf's ``shape``, the dim's :class:`DimShard` and the mesh,
    with the reductions that span the shards."""

    shape: tuple[int, ...]
    shard: DimShard
    mesh: object

    @property
    def dim(self) -> int:
        return self.shard.dim

    @property
    def size(self) -> int:
        return self.shard.size

    @property
    def numel(self) -> int:
        return numel(self.shape)

    def zero_pad(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` (this rank's shard) with its padding rows zeroed."""
        s = self.shard
        if s.valid == s.chunk:
            return x
        rows = torch.arange(s.chunk, device=x.device) < s.valid
        return x * rows.reshape([-1] + [1] * (x.ndim - 1 - s.dim)).to(
            x.dtype)

    def psum_(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the shards' ranks in place (no gradient)."""
        return psum_(x, self.mesh, self.shard.axes)

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every shard's ``x`` concatenated along ``dim`` (the leaf's
        sharded dim in ``x``'s coordinates), padding dropped."""
        return all_gather(x, self.mesh, self.shard.axes, dim=dim).narrow(
            dim, 0, self.size)

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a whole tensor broadcast against the leaf
        (size 1 along the sharded dim broadcasts as it is); padding rows
        hold 1."""
        if x.shape[self.dim] == 1:
            return x
        return shard_dim(x, self.shard, fill=1.0)
