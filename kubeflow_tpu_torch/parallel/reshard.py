"""Live train-state resharding between meshes; counterpart of
``kubeflow_tpu/parallel/reshard.py``.

JAX remaps a live pytree with one ``jax.device_put`` against the target
mesh's shardings. The port runs one process per device, so the move is
written out: :func:`reshard_state` takes a live ``TrainState`` (params,
optimizer slots, count and step) from one
:class:`~kubeflow_tpu_torch.train.trainer.StateLayout` to another,
**bit for bit**, as pure data movement (no arithmetic touches a value).
Every rank of the process group calls it at the same point, inside the
source mesh, the target mesh, both or neither.

The design. A shard is named by its block: for each dim a spec splits
over more than one shard, the shard count and its index. For each leaf
and each rank of the target mesh:

- a rank whose source shard is the block it needs keeps the tensor it
  holds (no copy);
- otherwise a source rank holding that block sends it to the rank (one
  point-to-point message; the source ranks that hold it take turns);
- otherwise (the non-data degrees changed) the source ranks gather the
  leaf whole over the source mesh and its first rank sends it whole; the
  rank cuts its block out.

Ranks are placed row-major with data outermost (``mesh.arrange_ranks``),
and :func:`scaled_mesh_config` changes only the data degree, so a rank
``r`` keeps its non-data coordinates across an elastic resize: a shrink
moves nothing to the ranks that stay, and a grow sends each new rank the
shards of a data peer (a rank ``r mod`` the fixed axes' product away).
The third case is there for layouts that differ otherwise.

When the source and target rank sets overlap the messages go over the
process group (``method="device"``: NCCL between GPUs; gloo takes a CUDA
tensor's bytes through the host); when they are disjoint, each block is
staged in host memory and sent over the gang's gloo group
(``method="host"``), as JAX stages a move between disjoint device sets.
:func:`reshard_state` returns once the moved shards are resident on every
rank. A rank that leaves the mesh gets None back and frees its shards
when the caller drops the old state.

As in JAX, the compute that follows on another mesh degree is f32
equivalent, not bitwise, to the old degree's (sums group differently), so
an elastic run is held bit for bit against the restore-into-target-mesh
path, not against a fixed-mesh run.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from kubeflow_tpu_torch.parallel.mesh import (
    AXIS_DATA,
    MESH_AXES,
    MeshConfig,
    mesh_ranks,
)
from kubeflow_tpu_torch.parallel.sharding import dim_shards, shard, unshard

# Bytes this process sent and received in reshards since it started (the
# counts a check reads to see what a resize moved, as
# parallel.collectives.BYTES shows what a step moved).
MOVED = {"sent": 0, "received": 0}


@dataclass
class ReshardStats:
    """What one remap did (the record the train result carries). ``leaves``
    and ``bytes`` count the whole logical state's tensors, not one rank's
    shards, as JAX's global arrays do."""

    from_devices: int = 0
    to_devices: int = 0
    method: str = "device"  # "device" | "host"
    leaves: int = 0
    bytes: int = 0
    seconds: float = 0.0

    @property
    def direction(self) -> str:
        return "grow" if self.to_devices >= self.from_devices else "shrink"

    def to_dict(self) -> dict:
        return {
            "from_devices": self.from_devices,
            "to_devices": self.to_devices,
            "direction": self.direction,
            "method": self.method,
            "leaves": self.leaves,
            "bytes": self.bytes,
            "seconds": round(self.seconds, 6),
        }


@dataclass
class ReshardResult:
    tree: object
    stats: ReshardStats = field(default_factory=ReshardStats)


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name.split(".")[-1])


def _block(shape, spec: tuple, mesh, rank: int) -> tuple:
    """The block ``rank`` holds of a leaf of ``shape`` under ``spec``:
    (dim, shard count, index) of each dim split more than one way."""
    return tuple((s.dim, s.n, s.index)
                 for s in dim_shards(shape, spec, mesh, rank) if s.n > 1)


def _block_shape(shape, block: tuple) -> tuple[int, ...]:
    out = list(shape)
    for dim, n, _ in block:
        out[dim] = -(-out[dim] // n)
    return tuple(out)


def _table(state, layout) -> dict:
    """The logical state's description, from a rank of the source mesh:
    the step, the optimizer's top-level order and count, and each tensor
    leaf's (slot, parameter key, whole shape, dtype) in the state's order
    (the order the optimizer sums the gradient norm in)."""
    leaves = []

    def add(slot, key, t):
        whole = list(t.shape)
        leaf = layout.leaf(key)
        if leaf is not None and len(layout.specs[key]) <= t.ndim:
            for s in leaf.shards:
                whole[s.dim] = s.size
        leaves.append((slot, key, tuple(whole), str(t.dtype)))

    from kubeflow_tpu_torch.weights import flatten

    for key, p in flatten(state.params).items():
        add("params", key, p)
    for slot, value in state.opt_state.items():
        if slot != "count":
            for key, t in value.items():
                add(slot, key, t)
    return {"step": state.step, "count": state.opt_state.get("count"),
            "slots": list(state.opt_state), "leaves": leaves}


def _exchange(pairs: list, payload, shape, dtype, device, method: str):
    """Each (source, target) pair's message: this rank sends ``payload``
    where it is a source and returns what it received where it is a
    target (None otherwise). The blocks travel over the process group
    itself, or on the host path over the gang's gloo group."""
    from kubeflow_tpu_torch.parallel.distributed import _side_group

    me = dist.get_rank()
    group = _side_group() if method == "host" else None
    backend = dist.get_backend(group)
    staged = method == "host" or (device.type != "cpu"
                                  and backend == "gloo")
    works, got = [], None
    if any(me == src for src, _ in pairs):
        buf = payload.contiguous()
        buf = buf.cpu() if staged else buf
    for src, dst in pairs:
        if me == src:
            MOVED["sent"] += buf.numel() * buf.element_size()
            works.append(dist.isend(buf, dst=dst, group=group))
        if me == dst:
            got = torch.empty(shape, dtype=dtype,
                              device="cpu" if staged else device)
            MOVED["received"] += got.numel() * got.element_size()
            works.append(dist.irecv(got, src=src, group=group))
    for w in works:
        w.wait()
    if got is not None and staged:
        got = got.to(device)
    return got


def reshard_state(state, src, dst) -> ReshardResult:
    """Move ``state`` (this rank's shards under the layout ``src``; None on
    a rank outside ``src``'s mesh) to the layout ``dst`` bit for bit and
    return this rank's shards under ``dst`` (None outside its mesh). Every
    rank of the process group calls it at the same point, with layouts of
    the same meshes, rules and shapes (a rank outside a mesh builds its
    layout all the same)."""
    from kubeflow_tpu_torch.parallel.distributed import (
        barrier,
        broadcast_object,
    )
    from kubeflow_tpu_torch.train.trainer import TrainState
    from kubeflow_tpu_torch.weights import _unflatten, flatten

    t0 = time.perf_counter()
    src_ranks, dst_ranks = mesh_ranks(src.mesh), mesh_ranks(dst.mesh)
    me = dist.get_rank()
    method = "device" if set(src_ranks) & set(dst_ranks) else "host"
    table = broadcast_object(_table(state, src) if me == src_ranks[0]
                             else None, src=src_ranks[0])
    if state is not None:
        params = flatten(state.params)
        local = {("params", k): t for k, t in params.items()}
        for slot, value in state.opt_state.items():
            if slot != "count":
                local.update({(slot, k): t for k, t in value.items()})
        device = next(iter(params.values())).device
    else:
        local = {}
        device = torch.device("cpu") if dst.mesh.device_type == "cpu" \
            else torch.device("cuda", torch.cuda.current_device())
    out, total = {}, 0
    for slot, key, whole, dtype_name in table["leaves"]:
        dtype = _dtype(dtype_name)
        total += math.prod(whole) * dtype.itemsize
        spec_s = src.spec_of(key, len(whole))
        spec_d = dst.spec_of(key, len(whole))
        held = {r: _block(whole, spec_s, src.mesh, r) for r in src_ranks}
        sends, to_whole = [], []
        for i, t in enumerate(dst_ranks):
            need = _block(whole, spec_d, dst.mesh, t)
            if held.get(t) == need:
                continue  # the rank keeps the tensor it holds
            peers = [r for r in src_ranks if held[r] == need]
            if peers:  # the holders of the block take turns
                sends.append((peers[i % len(peers)], t))
            else:
                to_whole.append(t)
        mine = local.get((slot, key))
        need_me = _block(whole, spec_d, dst.mesh, me) \
            if me in dst_ranks else None
        if need_me is not None and held.get(me) == need_me:
            out[(slot, key)] = mine
        # The peers' messages of this leaf go at once.
        if sends:
            got = _exchange(sends, mine, _block_shape(whole, need_me or ()),
                            dtype, device, method)
            if got is not None:
                out[(slot, key)] = got
        if to_whole:
            full = unshard(mine, spec_s, src.mesh, whole) \
                if mine is not None else None
            got = _exchange([(src_ranks[0], t) for t in to_whole
                             if t != src_ranks[0]], full, whole, dtype,
                            device, method)
            if me in to_whole:
                got = full if me == src_ranks[0] else got
                out[(slot, key)] = shard(got, spec_d, dst.mesh)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    # Resident everywhere before anyone times the move or frees a buffer.
    barrier("reshard")
    tree = None
    if me in dst_ranks:
        params = {k: out[("params", k)] for s, k, _, _ in table["leaves"]
                  if s == "params"}
        opt = {}
        for slot in table["slots"]:
            opt[slot] = table["count"] if slot == "count" else {
                k: out[(s, k)] for s, k, _, _ in table["leaves"] if s == slot}
        tree = TrainState(table["step"], _unflatten(params), opt, dst)
    stats = ReshardStats(from_devices=len(src_ranks),
                         to_devices=len(dst_ranks), method=method,
                         leaves=len(table["leaves"]), bytes=total,
                         seconds=time.perf_counter() - t0)
    return ReshardResult(tree=tree, stats=stats)


def scaled_mesh_config(base: MeshConfig, n_devices: int) -> MeshConfig:
    """The target mesh shape for an elastic resize: the **data** axis
    absorbs the change (the only axis whose degree is free of the model's
    geometry), every other axis keeps its degree. Raises when
    ``n_devices`` is not divisible by the fixed axes' product, or when a
    non-data axis is -1."""
    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    degrees = base.degrees()
    fixed = math.prod(d for a, d in degrees.items()
                      if a != AXIS_DATA and d != -1)
    if any(d == -1 for a, d in degrees.items() if a != AXIS_DATA):
        raise ValueError(
            "elastic resize needs every non-data axis degree explicit; "
            f"got {degrees}")
    if n_devices % fixed:
        raise ValueError(
            f"{n_devices} devices not divisible by the fixed axes' "
            f"product {fixed} — cannot scale the data axis")
    kwargs = {a: degrees[a] for a in MESH_AXES}
    kwargs[AXIS_DATA] = n_devices // fixed
    return MeshConfig(**kwargs, ici_axes=base.ici_axes)
