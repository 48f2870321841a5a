"""The device mesh with named parallelism axes; counterpart of
``kubeflow_tpu/parallel/mesh.py``.

The same six axes in the same order (data outermost, tensor innermost) and
the same ``MeshConfig``, built as a ``torch.distributed.device_mesh.
DeviceMesh`` over the running process group: rank ``r`` sits where JAX's
CPU branch puts device ``r``, the plain row-major reshape (the TPU torus
placement of ``arrange_devices`` has no counterpart on GPUs). Collectives
over a single axis use the mesh's own groups; the groups over several
axes (the batch's ``("data", "fsdp")``) are created with the mesh and
found by :func:`axis_group`.

A mesh may hold only some ranks of the process group (``ranks=``; an
elastic run's mesh after it shrinks, JAX's ``devices=jax.devices()[:n]``):
every rank builds it all the same, and a rank outside it
(:func:`is_member` False) holds no group of it and runs none of its
collectives. :func:`destroy_mesh` frees a replaced mesh's groups.

Every axis trains. The batch is sharded over :data:`BATCH_AXES` (and
its tokens over ``sequence`` under context parallelism); the ranks of a
:data:`MODEL_AXES` group, and of a ``pipeline`` group, hold the same rows
and differ only in which slice of a leaf they keep (none, for a family
whose rules do not name the axis: its ranks are replicas).
:func:`serving_mesh` is the single-process layout of a model-parallel
serving replica: the list of its devices; :class:`TensorShards` and
:class:`PipelineStages` hold its per-shard and per-stage values.
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

AXIS_DATA = "data"
AXIS_PIPELINE = "pipeline"
AXIS_FSDP = "fsdp"
AXIS_EXPERT = "expert"
AXIS_SEQUENCE = "sequence"
AXIS_TENSOR = "tensor"

MESH_AXES: tuple[str, ...] = (
    AXIS_DATA,
    AXIS_PIPELINE,
    AXIS_FSDP,
    AXIS_EXPERT,
    AXIS_SEQUENCE,
    AXIS_TENSOR,
)
# The axes a batch is sharded over (JAX's batch_spec), major first.
BATCH_AXES: tuple[str, ...] = (AXIS_DATA, AXIS_FSDP)
# The model axes: their ranks hold the same batch rows and differ only in
# which slice of a leaf they keep (an expert range, a tensor block).
MODEL_AXES: tuple[str, ...] = (AXIS_EXPERT, AXIS_TENSOR)


@dataclass(frozen=True)
class MeshConfig:
    """Degrees of each parallelism axis; at most one may be -1, meaning
    "the rest of the devices"."""

    data: int = -1
    pipeline: int = 1
    fsdp: int = 1
    expert: int = 1
    sequence: int = 1
    tensor: int = 1
    # Axes that must map onto one slice's interconnect (the operator's
    # topology allocator reads them); only an elastic resize carries them
    # over (parallel/reshard.py:scaled_mesh_config).
    ici_axes: tuple[str, ...] = field(
        default=(AXIS_EXPERT, AXIS_SEQUENCE, AXIS_TENSOR), repr=False)

    def degrees(self) -> dict[str, int]:
        return {
            AXIS_DATA: self.data,
            AXIS_PIPELINE: self.pipeline,
            AXIS_FSDP: self.fsdp,
            AXIS_EXPERT: self.expert,
            AXIS_SEQUENCE: self.sequence,
            AXIS_TENSOR: self.tensor,
        }

    def resolve(self, n_devices: int) -> dict[str, int]:
        """Fill in the one -1 axis and validate the product equals
        n_devices."""
        degrees = self.degrees()
        wildcard = [name for name, d in degrees.items() if d == -1]
        if len(wildcard) > 1:
            raise ValueError(f"at most one mesh axis may be -1, got {wildcard}")
        fixed = math.prod(d for d in degrees.values() if d != -1)
        if wildcard:
            if n_devices % fixed:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes "
                    f"product {fixed}")
            degrees[wildcard[0]] = n_devices // fixed
        elif fixed != n_devices:
            raise ValueError(
                f"mesh {degrees} needs {fixed} devices but {n_devices} are "
                "present")
        return degrees


def hybrid_shapes(degrees: dict[str, int], num_slices: int
                  ) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """Split resolved axis degrees into (per-slice shape, cross-slice
    shape): the slices span the data axis, whose degree must be a multiple
    of num_slices."""
    if degrees[AXIS_DATA] % num_slices:
        raise ValueError(
            f"data degree {degrees[AXIS_DATA]} not divisible by "
            f"num_slices {num_slices}; multislice scales the data axis")
    ici = tuple(
        degrees[a] // num_slices if a == AXIS_DATA else degrees[a]
        for a in MESH_AXES)
    dcn = tuple(num_slices if a == AXIS_DATA else 1 for a in MESH_AXES)
    return ici, dcn


def arrange_ranks(config: MeshConfig | None, n: int, *,
                  num_slices: int | None = None) -> np.ndarray:
    """Ranks ``0..n-1`` in the [data, pipeline, fsdp, expert, sequence,
    tensor] array: the plain reshape of JAX's CPU branch. With
    ``num_slices``, contiguous rank groups (one slice each) land on
    contiguous data rows, after ``hybrid_shapes`` checks the split."""
    degrees = (config or MeshConfig()).resolve(n)
    if num_slices is not None and num_slices < 1:
        raise ValueError(f"num_slices must be >= 1, got {num_slices}")
    if num_slices and num_slices > 1:
        hybrid_shapes(degrees, num_slices)
    return np.arange(n).reshape(tuple(degrees[a] for a in MESH_AXES))


def build_mesh(config: MeshConfig | None = None, *,
               device_type: str | None = None,
               num_slices: int | None = None, ranks=None):
    """A ``DeviceMesh`` with the six axis names over the ranks ``ranks``
    of the running process group (default: every rank), placed as
    :func:`arrange_ranks` places ``0..n-1`` (``ranks=range(n)``: the first
    ``n``, as JAX's ``build_mesh(..., devices=jax.devices()[:n])`` takes
    them). ``device_type`` defaults to ``"cuda"`` under NCCL and ``"cpu"``
    otherwise; each process must have set its device first.

    Every rank of the process group must call this at the same point,
    members of the mesh or not: its groups are created by all of them
    together. A rank outside the mesh holds none of them
    (:func:`is_member` is False there); :func:`destroy_mesh` frees a mesh
    that is replaced."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("build_mesh needs a running process group "
                           "(parallel.distributed.initialize_from_env)")
    world = dist.get_world_size()
    ranks = list(range(world)) if ranks is None else [int(r) for r in ranks]
    if not ranks or len(set(ranks)) != len(ranks) or \
            not all(0 <= r < world for r in ranks):
        raise ValueError(f"mesh ranks {ranks} are not distinct ranks of "
                         f"the process group of {world}")
    placed = np.asarray(ranks)[arrange_ranks(config, len(ranks),
                                             num_slices=num_slices)]
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    mesh = DeviceMesh(device_type, torch.from_numpy(placed),
                      mesh_dim_names=MESH_AXES)
    _create_groups(mesh)
    return mesh


def is_member(mesh) -> bool:
    """Whether this rank holds a place in ``mesh`` (no mesh: one process,
    always)."""
    return mesh is None or mesh.get_coordinate() is not None


def mesh_ranks(mesh) -> list[int]:
    """The mesh's ranks, in row-major order of its array."""
    return mesh.mesh.reshape(-1).tolist()


def destroy_mesh(mesh) -> None:
    """Free the process groups this rank holds of ``mesh`` (its axes' and
    the multi-axis ones), never the default group. Every rank calls it
    when a mesh is replaced (an elastic resize), so a gang that resizes
    many times does not pile groups up; the mesh must not be used after."""
    groups = [g for key, g in list(_GROUPS.items()) if key[0] is mesh]
    for key in [key for key in _GROUPS if key[0] is mesh]:
        del _GROUPS[key]
    if is_member(mesh):
        groups += [mesh.get_group(a) for a in MESH_AXES]
    seen = set()
    for group in groups:
        if group is None or group is dist.group.WORLD or id(group) in seen:
            continue
        seen.add(id(group))
        dist.destroy_process_group(group)


def single_device_mesh(device_type: str | None = None):
    """A 1x1x1x1x1x1 mesh, so one process runs the mesh path; needs a
    process group of one rank."""
    return build_mesh(MeshConfig(data=1), device_type=device_type)


def _names(axes) -> tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def mesh_degrees(mesh) -> dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def axis_size(mesh, axes) -> int:
    """The product of the degrees of ``axes`` (a name or a tuple)."""
    degrees = mesh_degrees(mesh)
    return math.prod(degrees[a] for a in _names(axes))


def tensor_mesh(mesh):
    """``mesh`` when its tensor axis is above 1, else None: where
    Megatron's collectives run."""
    if mesh is not None and axis_size(mesh, AXIS_TENSOR) > 1:
        return mesh
    return None


def rank_coordinate(mesh, rank: int | None = None) -> tuple[int, ...] | None:
    """The coordinates of ``rank`` (default: this rank) in the mesh's
    array, or None when it holds no place there."""
    if rank is None:
        return mesh.get_coordinate()
    hit = (mesh.mesh == rank).nonzero()
    return tuple(hit[0].tolist()) if len(hit) else None


def axis_index(mesh, axes, rank: int | None = None) -> int:
    """The index of ``rank`` (default: this rank) along ``axes`` taken
    together, the first axis major (the order a spec entry ``("data",
    "fsdp")`` shards in)."""
    coords = dict(zip(mesh.mesh_dim_names, rank_coordinate(mesh, rank)))
    index = 0
    for a in _names(axes):
        index = index * mesh_degrees(mesh)[a] + coords[a]
    return index


_GROUPS: dict = {}


def _live_axes(mesh, names) -> tuple[str, ...]:
    """``names`` without the axes of degree 1, which group nothing."""
    degrees = mesh_degrees(mesh)
    return tuple(a for a in names if degrees[a] > 1)


def _create_groups(mesh) -> None:
    """The groups of peers along every combination of two or more of the
    mesh's axes of degree above 1 (an axis of degree 1 changes no group,
    so these are all the groups :func:`axis_group` can be asked for). All
    ranks of the process group create them together, members of the mesh
    or not (collective creation), each keeping the ones it belongs to."""
    live = _live_axes(mesh, MESH_AXES)
    me = dist.get_rank()
    for k in range(2, len(live) + 1):
        for names in itertools.combinations(live, k):
            dims = [mesh.mesh_dim_names.index(a) for a in names]
            rest = [d for d in range(mesh.mesh.ndim) if d not in dims]
            # Peers share every coordinate but those of `names`; their
            # ranks in the order of `names`, the first major.
            grid = mesh.mesh.permute(*rest, *dims).reshape(-1, math.prod(
                mesh.mesh.shape[d] for d in dims))
            _GROUPS[(mesh, names)] = None
            for ranks in grid.tolist():
                group = dist.new_group(ranks)
                if me in ranks:
                    _GROUPS[(mesh, names)] = group


def axis_group(mesh, axes):
    """The process group of this rank's peers along ``axes`` (a name or a
    tuple), the axes of degree 1 left out: the mesh's own group for one
    axis, for several the group :func:`build_mesh` made."""
    names = _names(axes)
    live = _live_axes(mesh, names)
    if len(live) <= 1:
        return mesh.get_group(live[0] if live else names[0])
    # A group's members are the same whatever the order of its axes (its
    # ranks are ordered by rank).
    return _GROUPS[(mesh, tuple(sorted(live, key=MESH_AXES.index)))]


class TensorShards(list):
    """The per-shard values of a tensor-parallel serving replica, in shard
    order: its parameter trees (``parallel.sharding.split_tensor``), or
    one side of its KV store split over the KV heads (``models/decode.py:
    shard_decode_state``), one contiguous tensor a shard on that shard's
    device. A plain value stands for one shard."""


class PipelineStages(list):
    """The per-stage values of a pipeline-parallel serving replica, in
    stage order: each stage's parameter tree (its layers' slice of the
    stacked leaves, the rest whole) or its slice of the KV store's layer
    dim, each a plain value or the stage's :class:`TensorShards`."""


def serving_mesh(tp: int, *, cp: int = 1, pp: int = 1,
                 devices=None) -> list[torch.device]:
    """The devices of a model-parallel serving replica, one process
    driving all of them: ``pp * cp * tp`` devices in JAX's ``serving_mesh``
    order, the pipeline outermost, then the sequence ring, the tensor
    shards innermost (replica device ``(p * cp + c) * tp + t`` runs stage
    ``p``'s ring shard ``c`` of tensor shard ``t``). ``devices`` names
    them, repeats allowed (two shards of one card: ``["cuda:0",
    "cuda:0"]``; on the host ``["cpu"] * n``), the first ``n`` taken as
    JAX takes them; None takes ``cuda:0`` .. ``cuda:n-1``. Fewer devices
    than ``n`` raise JAX's message. A shard is never placed anywhere the
    caller did not name."""
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    if cp < 1:
        raise ValueError(f"cp must be >= 1, got {cp}")
    if pp < 1:
        raise ValueError(f"pp must be >= 1, got {pp}")
    need = tp * cp * pp
    if devices is None:
        visible = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        devices = [torch.device("cuda", i) for i in range(visible)]
    devices = [torch.device(d) for d in devices]
    if len(devices) < need:
        raise ValueError(
            f"tp={tp} cp={cp} pp={pp} needs {need} devices but only "
            f"{len(devices)} are visible")
    devices = devices[:need]
    for d in devices:
        if d.type == "cuda" and (not torch.cuda.is_available() or (
                d.index or 0) >= torch.cuda.device_count()):
            raise ValueError(f"device {d} is not visible (devices: "
                             f"{torch.cuda.device_count()} CUDA)")
    return [torch.device("cuda", d.index or 0) if d.type == "cuda" else d
            for d in devices]
