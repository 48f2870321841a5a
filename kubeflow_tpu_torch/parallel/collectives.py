"""Collectives over named mesh axes; counterpart of
``kubeflow_tpu/parallel/collectives.py``.

JAX calls these inside ``shard_map`` regions and finds the mesh from the
region; the port runs one process per device (SPMD by construction, so
``shard_map`` has no counterpart) and names the mesh. ``axis`` is one axis
name or a tuple of them, taken together (the first major).

``psum``, ``all_gather`` and ``reduce_scatter`` carry gradients, as
JAX's do under ``jax.grad``: each rank's loss is its own term of the
global loss, so psum's backward is a psum of the cotangents, all_gather's
is a reduce-scatter and reduce_scatter's an all-gather. ``psum_`` is the
sum without a gradient, in place (no copy of a gradient buffer); every
sum over the mesh in the package goes through it (the gang's host
agreements ride their own gloo group, ``parallel.distributed``). The
collectives run at every degree, 1 included.

The model axes need other gradients (Megatron's pair): every rank of a
``tensor`` or ``expert`` group holds the same rows and computes the same
loss, so a sum over them with psum's backward would hand each rank ``tp``
times its gradient. :func:`copy_to_tensor` (identity forward, psum
backward) goes before a column-parallel product, :func:`reduce_from_tensor`
(psum forward, identity backward) after a row-parallel one; both take an
axis or a tuple of axes (the mixture of experts sums its partial outputs
over ``("expert", "tensor")`` at once). :func:`gather_from_tensor` joins
vocab-sharded logits, its backward taking this rank's slice.
:func:`gather_counts` all-gathers small integer counts without a
gradient. :func:`reduce_shards` is the single-process sum of a serving
replica's shards (no process group). :func:`ring_permute` is JAX's
``ppermute`` by a shift, whose gradient is the permute back: the ring of
``parallel/ring_attention.py`` and the stage-to-stage send of
``parallel/pipeline.py``.

``reduce_scatter_tensor`` and ``all_gather_into_tensor`` are the names
every torch release of this port's range has.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from kubeflow_tpu_torch.parallel.mesh import (  # noqa: F401 (re-exported)
    axis_group,
    axis_index,
    axis_size,
    tensor_mesh,
)


# Calls of each collective and the bytes each rank put in, since the last
# reset_counts(): a check reads them to see that a path went through the
# collectives, as kernels.LAUNCHES shows it went through the kernels.
CALLS = {"all_reduce": 0, "all_gather": 0, "reduce_scatter": 0,
         "ppermute": 0}
BYTES = dict.fromkeys(CALLS, 0)


def reset_counts() -> None:
    for counts in (CALLS, BYTES):
        for op in counts:
            counts[op] = 0


def _count(op: str, x) -> None:
    CALLS[op] += 1
    BYTES[op] += x.numel() * x.element_size()


def _gather_dim0(x, group, n):
    _count("all_gather", x)
    out = x.new_empty((n * x.shape[0], *x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out


def _scatter_dim0(x, group, n):
    _count("reduce_scatter", x)
    out = x.new_empty((x.shape[0] // n, *x.shape[1:]))
    dist.reduce_scatter_tensor(out, x.contiguous(), group=group)
    return out


def _gather_along(x, dim: int, group, n: int):
    """The ``n`` shards of the group concatenated along ``dim``."""
    if dim == 0:
        return _gather_dim0(x, group, n)
    return _gather_dim0(x.movedim(dim, 0), group, n).movedim(
        0, dim).contiguous()


def _scatter_along(x, dim: int, group, n: int):
    """The sum over the group of ``x``, this rank's ``1/n`` of it along
    ``dim``; ``x.shape[dim]`` must divide by ``n``."""
    if dim == 0:
        return _scatter_dim0(x, group, n)
    return _scatter_dim0(x.movedim(dim, 0), group, n).movedim(
        0, dim).contiguous()


def psum_(x, mesh, axis):
    """Sum ``x`` over ``axis`` IN PLACE, without a gradient, and return
    it."""
    _count("all_reduce", x)
    dist.all_reduce(x, group=axis_group(mesh, axis))
    return x


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return psum_(x.clone(), mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return psum_(g.clone(), ctx.mesh, ctx.axis), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, n):
        ctx.dim, ctx.group, ctx.n = dim, group, n
        return _gather_along(x, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        return _scatter_along(g, ctx.dim, ctx.group, ctx.n), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, n):
        ctx.dim, ctx.group, ctx.n = dim, group, n
        return _scatter_along(x, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        return _gather_along(g, ctx.dim, ctx.group, ctx.n), None, None, None


class _CopyToTensor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return psum_(g.clone(), ctx.mesh, ctx.axis), None, None


class _ReduceFromTensor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return psum_(x.clone(), mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherFromTensor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, n, index):
        ctx.dim, ctx.index, ctx.width = dim, index, x.shape[dim]
        return _gather_along(x, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        return (g.narrow(ctx.dim, ctx.index * ctx.width, ctx.width)
                .contiguous(), None, None, None, None)


def psum(x, mesh, axis):
    """The sum of ``x`` over ``axis``, on every rank of it."""
    return _PSum.apply(x, mesh, axis)


def copy_to_tensor(x, mesh, axis="tensor"):
    """``x`` as it is, whose gradient is summed over ``axis`` (a name or
    a tuple): the input of a column-parallel product, whose ranks each
    see a part of the gradient of a replicated ``x``."""
    return _CopyToTensor.apply(x, mesh, axis)


def reduce_from_tensor(x, mesh, axis="tensor"):
    """The sum over ``axis`` (a name or a tuple) of a row-parallel
    product's partial outputs; its gradient passes through as it is
    (every rank holds the whole gradient of the replicated sum)."""
    return _ReduceFromTensor.apply(x, mesh, axis)


def tensor_copy(x, mesh):
    """:func:`copy_to_tensor` over ``mesh``'s tensor axis, or ``x`` as it
    is where Megatron's collectives do not run (:func:`tensor_mesh` is
    None: no mesh, or a tensor degree of 1)."""
    return x if tensor_mesh(mesh) is None else copy_to_tensor(x, mesh)


def tensor_sum(x, mesh):
    """:func:`reduce_from_tensor` over ``mesh``'s tensor axis, or ``x`` as
    it is where Megatron's collectives do not run."""
    return x if tensor_mesh(mesh) is None else reduce_from_tensor(x, mesh)


def gather_counts(x, mesh, axis):
    """Every rank's ``x`` (small integer counts) stacked along a new
    leading dim in the order of ``axis`` (a name or a tuple), without a
    gradient."""
    n = axis_size(mesh, axis)
    return _gather_dim0(x.detach().reshape(1, *x.shape),
                        axis_group(mesh, axis), n)


def gather_from_tensor(x, mesh, axis="tensor", *, dim: int = -1):
    """The shards of ``axis`` concatenated along ``dim`` (vocab-sharded
    logits made whole); the gradient is this rank's slice of the whole
    one, which every rank computes alike."""
    dim = dim % x.ndim
    return _GatherFromTensor.apply(x, dim, axis_group(mesh, axis),
                                   axis_size(mesh, axis),
                                   axis_index(mesh, axis))


def reduce_shards(parts: list) -> list:
    """The sum of a serving replica's per-shard partial outputs (one
    process, one tensor a shard), added in shard order on shard 0's
    device, so the result does not depend on the placement; returned on
    each shard's device. One shard's part comes back as it is."""
    if len(parts) == 1:
        return list(parts)
    dev = parts[0].device
    total = parts[0]
    for p in parts[1:]:
        total = total + p.to(dev)
    return [total.to(p.device) for p in parts]


def pmean(x, mesh, axis):
    return psum(x, mesh, axis) / axis_size(mesh, axis)


def all_gather(x, mesh, axis, *, dim: int = 0, tiled: bool = True):
    """The shards of ``axis`` concatenated along ``dim`` (``tiled``) or
    stacked on a new leading axis at ``dim``."""
    n = axis_size(mesh, axis)
    group = axis_group(mesh, axis)
    if not tiled:
        return _AllGather.apply(x.unsqueeze(dim), dim, group, n)
    return _AllGather.apply(x, dim, group, n)


def reduce_scatter(x, mesh, axis, *, dim: int = 0):
    """The sum over ``axis`` of ``x``, this rank's block of it along
    ``dim`` (JAX's ``psum_scatter`` with ``tiled=True``)."""
    return _ReduceScatter.apply(x, dim, axis_group(mesh, axis),
                                axis_size(mesh, axis))


def _permute(x, mesh, axis: str, shift: int):
    """``x`` sent ``shift`` steps round the ring of ``axis``, what the
    opposite neighbour sent received (no gradient). gloo takes a CUDA
    tensor's bytes through host memory."""
    _count("ppermute", x)
    n = axis_size(mesh, axis)
    if shift % n == 0:
        return x.detach().clone()
    group = axis_group(mesh, axis)
    i = axis_index(mesh, axis)
    ranks = dist.get_process_group_ranks(group)
    staged = x.device.type != "cpu" and dist.get_backend(group) == "gloo"
    send = x.detach().contiguous()
    if staged:
        send = send.cpu()
    out = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, ranks[(i + shift) % n], group),
           dist.P2POp(dist.irecv, out, ranks[(i - shift) % n], group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out.to(x.device) if staged else out


class _RingPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, shift):
        ctx.mesh, ctx.axis, ctx.shift = mesh, axis, shift
        return _permute(x, mesh, axis, shift)

    @staticmethod
    def backward(ctx, g):
        return _permute(g, ctx.mesh, ctx.axis, -ctx.shift), None, None, None


def ring_permute(x, mesh, axis: str, *, shift: int = 1):
    """Send ``x`` to the neighbour ``shift`` steps around the ring of
    ``axis`` and return what the opposite neighbour sent (JAX's
    ``ppermute`` with the pairs ``(i, i + shift)``). Its gradient is the
    permute by ``-shift``, JAX's transpose of ``ppermute``. Every rank of
    the ring must call it at the same point, in the forward and, where a
    gradient flows, in the backward."""
    return _RingPermute.apply(x, mesh, axis, shift)


def allreduce_mean(mesh, axis):
    """A function ``x -> pmean(x)`` over ``axis`` (psum / n, the Horovod
    convention), for measuring a collective rather than for training."""

    def _allreduce(x):
        with torch.no_grad():
            return pmean(x, mesh, axis)

    return _allreduce


def global_norm_sq(tensors, mesh=None, axis=None):
    """Sum of squares of every element of ``tensors`` (at least one) in
    float32, summed over ``axis`` too when one is named."""
    total = sum(torch.sum(torch.square(t.float())) for t in tensors)
    if axis is not None:
        total = psum(total, mesh, axis)
    return total
