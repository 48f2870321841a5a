"""The gang's rendezvous from the job's environment; counterpart of
``kubeflow_tpu/parallel/distributed.py``.

The JaxJob controller injects the coordinator's address, the number of
processes and each one's id (the names of ``kubeflow_tpu/apis/jobs.py``,
copied here). The JAX package runs one process per host with all its
chips in it; the port runs one process per GPU, as torch does, so a gang
of ``JAX_NUM_PROCESSES`` processes holds that many devices. Each joins
``torch.distributed``: NCCL when its device is CUDA, gloo when it is the
CPU. A single process joins nothing, as JAX's no-op rendezvous does.

The agreements (:func:`global_any`, :func:`global_min_int`,
:func:`broadcast_object`, :func:`barrier`) exchange host values over a
gloo group beside the main one, as JAX's ride the coordination
service's key-value store: no device work and no CUDA sync enters the
step. Every process must call each at the same point of its loop and the
same number of times.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

# The controller's environment (kubeflow_tpu/apis/jobs.py:83-88).
ENV_COORDINATOR_ADDRESS = "JAX_COORDINATOR_ADDRESS"
ENV_NUM_PROCESSES = "JAX_NUM_PROCESSES"
ENV_PROCESS_ID = "JAX_PROCESS_ID"
ENV_SLICE_ID = "MEGASCALE_SLICE_ID"
ENV_NUM_SLICES = "MEGASCALE_NUM_SLICES"
ENV_MEGASCALE_COORDINATOR = "MEGASCALE_COORDINATOR_ADDRESS"

# How long a collective or an agreement waits for a peer before raising:
# a peer that died leaves a timeout, not a hang.
DEFAULT_TIMEOUT_S = 600.0


@dataclass(frozen=True)
class ProcessInfo:
    coordinator_address: str | None
    num_processes: int
    process_id: int
    # Multislice topology (the MEGASCALE pair). Every GPU of the gang is
    # one rank of one process group, so the slices only name where the
    # data axis crosses hosts.
    num_slices: int = 1
    slice_id: int = 0
    megascale_coordinator: str | None = None

    @property
    def is_distributed(self) -> bool:
        return self.num_processes > 1

    @property
    def is_multislice(self) -> bool:
        return self.num_slices > 1


def process_info_from_env(environ=None) -> ProcessInfo:
    env = os.environ if environ is None else environ
    return ProcessInfo(
        coordinator_address=env.get(ENV_COORDINATOR_ADDRESS),
        num_processes=int(env.get(ENV_NUM_PROCESSES, "1")),
        process_id=int(env.get(ENV_PROCESS_ID, "0")),
        num_slices=int(env.get(ENV_NUM_SLICES, "1")),
        slice_id=int(env.get(ENV_SLICE_ID, "0")),
        megascale_coordinator=env.get(ENV_MEGASCALE_COORDINATOR),
    )


def local_device(info: ProcessInfo, device: str | torch.device = "cuda"
                 ) -> torch.device:
    """This process's device: ``cuda:{process_id % GPUs on the host}``
    unless ``device`` is the CPU (one process per GPU)."""
    from kubeflow_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda",
                           info.process_id % torch.cuda.device_count())
    return dev


def initialize_from_env(environ=None, *,
                        device: str | torch.device = "cuda",
                        backend: str | None = None,
                        timeout_s: float = DEFAULT_TIMEOUT_S) -> ProcessInfo:
    """Join the gang's process group; a no-op for a single process, so
    one worker image runs on one GPU or many.

    The group is NCCL when this process's device (:func:`local_device`)
    is CUDA and gloo when it is the CPU, unless ``backend`` names one (two
    ranks on one GPU must take gloo: NCCL refuses them). Rank 0 listens at
    the coordinator's address. A process that has joined already stays
    in its group (two runs of the loop in one worker)."""
    info = process_info_from_env(environ)
    if info.is_multislice and not info.megascale_coordinator:
        raise RuntimeError(
            f"{ENV_NUM_SLICES}>1 but {ENV_MEGASCALE_COORDINATOR} is "
            "unset; the JaxJob controller must inject the DCN "
            "coordinator address")
    if info.is_distributed and not dist.is_initialized():
        if not info.coordinator_address:
            raise RuntimeError(
                f"{ENV_NUM_PROCESSES}>1 but {ENV_COORDINATOR_ADDRESS} is "
                "unset; the JaxJob controller must inject the coordinator "
                "service address")
        dev = local_device(info, device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend or ("nccl" if dev.type == "cuda" else "gloo"),
            init_method=f"tcp://{info.coordinator_address}",
            world_size=info.num_processes, rank=info.process_id,
            timeout=datetime.timedelta(seconds=timeout_s))
        _side_group()
    return info


def initialize_gang(environ=None, *, device: str | torch.device = "cuda",
                    backend: str | None = None,
                    timeout_s: float = DEFAULT_TIMEOUT_S) -> ProcessInfo:
    """:func:`initialize_from_env`, and a process group of this one rank
    when the environment names no gang (on a free local port), so a
    collective runs through NCCL or gloo at world size 1 too, as a psum
    over one device does in JAX."""
    info = initialize_from_env(environ, device=device, backend=backend,
                               timeout_s=timeout_s)
    if not dist.is_initialized():
        from kubeflow_tpu_torch.parallel.launch import free_port

        dev = local_device(info, device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend or ("nccl" if dev.type == "cuda" else "gloo"),
            init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1,
            rank=0, timeout=datetime.timedelta(seconds=timeout_s))
    return info


def world_size() -> int:
    """Ranks in the running process group; 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


_SIDE: dict = {}


def _side_group():
    """The gloo group the agreements ride (the main group itself when it
    is gloo). Created once per process group, by every rank at the same
    point (:func:`initialize_from_env` creates it at once)."""
    default = dist.group.WORLD
    if _SIDE.get("for") is not default:
        _SIDE["for"] = default
        _SIDE["group"] = (None if dist.get_backend() == "gloo" else
                          dist.new_group(backend="gloo"))
    return _SIDE["group"]


def _all_reduce_int(value: int, op, timeout_ms: int) -> int:
    t = torch.tensor([int(value)], dtype=torch.int64)
    work = dist.all_reduce(t, op=op, group=_side_group(), async_op=True)
    work.wait(datetime.timedelta(milliseconds=timeout_ms))
    return int(t.item())


def global_any(flag: bool, *, timeout_ms: int = 60_000) -> bool:
    """True on every process iff ANY process passed True: the per-step
    agreement that makes a preemption collective-safe. Kubernetes delivers
    SIGTERM to each pod at a different step, but the checkpoint save is a
    collective, so every process must stop (and save) at the same step.
    A single process returns its own flag."""
    if world_size() <= 1:
        return bool(flag)
    return bool(_all_reduce_int(1 if flag else 0, dist.ReduceOp.MAX,
                                timeout_ms))


def global_min_int(value: int, *, timeout_ms: int = 60_000) -> int:
    """The minimum of ``value`` over the gang, on every process (the
    elastic reshard's agreement). A single process returns its value."""
    if world_size() <= 1:
        return int(value)
    return _all_reduce_int(value, dist.ReduceOp.MIN, timeout_ms)


def broadcast_object(value, src: int = 0):
    """Rank ``src``'s ``value`` (any picklable object) on every process,
    over the host group; a single process returns its own."""
    if world_size() <= 1:
        return value
    box = [value]
    dist.broadcast_object_list(box, src=src, group=_side_group())
    return box[0]


def barrier(name: str = "barrier") -> None:
    """Block until every process reaches this point (checkpoint commits,
    teardown). ``name`` labels the point, as JAX's does."""
    del name
    if world_size() > 1:
        dist.barrier(group=_side_group())


def shutdown(timeout_s: float = 30.0) -> None:
    """Leave the process group, if this process joined one. The ranks
    first wait for each other (``timeout_s`` at most, so a dead peer
    cannot hold the exit), so rank 0, which hosts the rendezvous store,
    does not tear it down while a peer still uses it."""
    from kubeflow_tpu_torch.parallel import mesh

    if dist.is_initialized():
        if dist.get_world_size() > 1:
            try:
                dist.monitored_barrier(
                    group=_side_group(),
                    timeout=datetime.timedelta(seconds=timeout_s))
            except RuntimeError:
                pass
        dist.destroy_process_group()
    _SIDE.clear()
    mesh._GROUPS.clear()
