"""The device mesh with named parallelism axes; counterpart of
``kubeflow_tpu/parallel/mesh.py``.

The same six axes in the same order (data outermost, tensor innermost) and
the same ``MeshConfig``, built as a ``torch.distributed.device_mesh.
DeviceMesh`` over the running process group: rank ``r`` sits where JAX's
CPU branch puts device ``r``, the plain row-major reshape (the TPU torus
placement of ``arrange_devices`` has no counterpart on GPUs). Collectives
over a single axis use the mesh's own groups; a group over several axes
(the batch's ``("data", "fsdp")``) is created by :func:`axis_group`.

Every axis trains; a family refuses the axes it does not run over with
:func:`require_axes`. The batch is sharded over :data:`BATCH_AXES` (and
its tokens over ``sequence`` under context parallelism); the ranks of a
:data:`MODEL_AXES` group, and of a ``pipeline`` group, hold the same rows
and differ only in which slice of a leaf they keep. :func:`serving_mesh`
is the single-process layout of a model-parallel serving replica: the
list of its devices; :class:`TensorShards` and :class:`PipelineStages`
hold its per-shard and per-stage values.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

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
               num_slices: int | None = None):
    """A ``DeviceMesh`` over every rank of the running process group, with
    the six axis names. ``device_type`` defaults to ``"cuda"`` under NCCL
    and ``"cpu"`` otherwise; each process must have set its device first.
    Every rank must call this at the same point."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("build_mesh needs a running process group "
                           "(parallel.distributed.initialize_from_env)")
    ranks = arrange_ranks(config, dist.get_world_size(),
                          num_slices=num_slices)
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    mesh = DeviceMesh(device_type, torch.from_numpy(ranks),
                      mesh_dim_names=MESH_AXES)
    # Every rank creates the multi-axis groups here, together.
    axis_group(mesh, BATCH_AXES)
    axis_group(mesh, MODEL_AXES)
    return mesh


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


def axis_index(mesh, axes) -> int:
    """This rank's index along ``axes`` taken together, the first axis
    major (the order a spec entry ``("data", "fsdp")`` shards in)."""
    coords = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    index = 0
    for a in _names(axes):
        index = index * mesh_degrees(mesh)[a] + coords[a]
    return index


_GROUPS: dict = {}


def axis_group(mesh, axes):
    """The process group of this rank's peers along ``axes`` (a name or a
    tuple): the mesh's own group for one axis; for several, a group made
    the first time they are asked for, by every rank at once (collective
    creation), each keeping the one it belongs to."""
    names = _names(axes)
    if len(names) == 1:
        return mesh.get_group(names[0])
    key = (mesh, names)
    if key not in _GROUPS:
        dims = [mesh.mesh_dim_names.index(a) for a in names]
        rest = [d for d in range(mesh.mesh.ndim) if d not in dims]
        # Peers share every coordinate but those of `names`; their ranks
        # in the order of `names`, the first major.
        grid = mesh.mesh.permute(*rest, *dims).reshape(-1, math.prod(
            mesh.mesh.shape[d] for d in dims))
        me = dist.get_rank()
        for ranks in grid.tolist():
            group = dist.new_group(ranks)
            if me in ranks:
                _GROUPS[key] = group
    return _GROUPS[key]


def require_axes(mesh, allowed: tuple[str, ...], what: str) -> None:
    """Raise ValueError("... not yet ported") naming the first axis
    outside ``allowed`` whose degree is above 1."""
    ported = " and ".join([", ".join(allowed[:-1]), allowed[-1]]
                          if len(allowed) > 1 else allowed)
    for name, degree in mesh_degrees(mesh).items():
        if degree > 1 and name not in allowed:
            raise ValueError(
                f"{what} over the {name!r} mesh axis (degree {degree}) is "
                f"not yet ported to the PyTorch package; the {ported} axes "
                "are")


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
